"""Attention U-Net over a registry encoder (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/attentionunet.py``: each
decoder step upsamples ×2, gates the skip with an additive attention gate
driven by the upsampled map, concatenates both and runs two conv-BN-ReLU;
with ``deep_supervision`` the inner steps get side heads. ``input_size``
is the input side a Swin encoder's windows are built for (other encoders
ignore it).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .encoders import get_encoder
from .modules.layers import (AttentionGate, ConvBNReLU, PortModule,
                             SegmentationHead, upsample2x)


class AttentionUnet(PortModule):
    """NCHW input → fp32 logits; with ``deep_supervision`` (final, [side
    heads of decoder steps 1..n-2])."""

    def __init__(self, encoder_name: str = "resnet50",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1, deep_supervision: bool = False,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.deep_supervision = dtype, deep_supervision
        self.encoder, enc_channels = get_encoder(
            encoder_name, dtype=dtype, input_size=input_size)
        feats = enc_channels[1:][::-1]      # head first: c4, c3, c2, c1, c0
        self.n_steps, self.n_skips = len(decoder_channels), len(feats) - 1
        cin = feats[0]
        for i, out_ch in enumerate(decoder_channels):
            cat = cin
            if i < self.n_skips:
                self.add_module(f"gate{i}", AttentionGate(
                    cin, feats[i + 1], max(out_ch // 2, 8), dtype=dtype))
                cat += feats[i + 1]
            self.add_module(f"dec{i}_conv1",
                            ConvBNReLU(cat, out_ch, dtype, 0.0))
            self.add_module(f"dec{i}_conv2",
                            ConvBNReLU(out_ch, out_ch, dtype, 0.0))
            cin = out_ch
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  classes, dtype=dtype)
        if deep_supervision:
            for i, ch in enumerate(decoder_channels[1:-1]):
                self.add_module(f"side_head{i}",
                                SegmentationHead(ch, classes, dtype=dtype))

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        feats = features[1:][::-1]
        y, preds = feats[0], []
        for i in range(self.n_steps):
            y_up = upsample2x(y)
            if i < self.n_skips:
                gated = getattr(self, f"gate{i}")(y_up, feats[i + 1])
                y_up = [y_up, gated]        # concatenated by conv1
            y = getattr(self, f"dec{i}_conv1")(y_up)
            y = getattr(self, f"dec{i}_conv2")(y)
            preds.append(y)
        final = self.segmentation_head(preds[-1])
        if self.deep_supervision:
            return final, [getattr(self, f"side_head{i}")(p)
                           for i, p in enumerate(preds[1:-1])]
        return final
