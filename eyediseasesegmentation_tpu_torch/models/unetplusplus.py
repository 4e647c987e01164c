"""UNet++ with optional deep supervision (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/unetplusplus.py``: a
registry encoder and the nested dense decoder without the star variant's
cross-axial gates and without ``pallas_tail`` (the JAX class passes
neither), so no decode-node kernel runs here. The encoder is built with its
default ``base_dim``, as in the JAX package: the axial encoders fit a 1024²
input only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .decoders import UnetPlusPlusDecoder
from .encoders import get_encoder
from .modules.layers import ClassificationHead, PortModule, SegmentationHead


class UnetPlusPlus(PortModule):
    """NCHW input → fp32 logits; with ``deep_supervision`` (mask, [heads of
    x_3_3, x_2_3, x_1_3]); with ``clf_head`` the classification logits
    appended."""

    def __init__(self, encoder_name: str = "resnet34",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None,
                 classes: int = 1, deep_supervision: bool = False,
                 clf_head: bool = False, drop_block_prob: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision, self.clf_head = deep_supervision, clf_head
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.decoder = UnetPlusPlusDecoder(
            enc_channels, decoder_channels,
            attention_type=decoder_attention_type,
            deep_supervision=deep_supervision,
            drop_block_prob=drop_block_prob, dtype=dtype)
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  classes, dtype=dtype)
        if clf_head:
            self.classification_head = ClassificationHead(
                enc_channels[-1], classes, dropout=0.2, dtype=dtype)
        if deep_supervision:
            # x_3_3, x_2_3 and x_1_3 all have the width of the /2 skip
            for i in range(3):
                self.add_module(f"deep_head{i}", SegmentationHead(
                    enc_channels[1], classes, dtype=dtype))

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        clf = (self.classification_head(features[-1]) if self.clf_head
               else None)
        out = self.decoder(features)
        if self.deep_supervision:
            final, deeps = out
            ds = [getattr(self, f"deep_head{i}")(f)
                  for i, f in enumerate(deeps)]
            mask = self.segmentation_head(final)
            return (mask, ds, clf) if self.clf_head else (mask, ds)
        mask = self.segmentation_head(out)
        return (mask, clf) if self.clf_head else mask
