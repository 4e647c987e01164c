"""Plain encoder-decoder U-Net (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/unet.py`` (smp.Unet):
a registry encoder, ``UnetDecoder`` and the segmentation head. The encoder
is built with its default ``base_dim``, as in the JAX package, so the axial
encoders fit a 1024² input only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .decoders import UnetDecoder
from .encoders import get_encoder
from .modules.layers import ClassificationHead, PortModule, SegmentationHead


class Unet(PortModule):
    """NCHW input → fp32 logits (N, classes, H, W); with ``clf_head`` also
    the classification logits of the deepest feature."""

    def __init__(self, encoder_name: str = "resnet34",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None,
                 classes: int = 1, clf_head: bool = False,
                 drop_block_prob: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.clf_head = dtype, clf_head
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.decoder = UnetDecoder(enc_channels, decoder_channels,
                                   attention_type=decoder_attention_type,
                                   drop_block_prob=drop_block_prob,
                                   dtype=dtype)
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  classes, dtype=dtype)
        if clf_head:
            self.classification_head = ClassificationHead(
                enc_channels[-1], classes, dropout=0.2, dtype=dtype)

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        mask = self.segmentation_head(self.decoder(features))
        if self.clf_head:
            return mask, self.classification_head(features[-1])
        return mask
