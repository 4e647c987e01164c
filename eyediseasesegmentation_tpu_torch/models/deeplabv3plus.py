"""DeepLabV3+ segmentation (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/deeplabv3plus.py``: ASPP
on the /32 feature, upsampled ×8 to the /4 level and concatenated with a
48-channel 1×1 projection of the /4 feature, two fused conv-BN-ReLU and a
head upsampled ×4. ``deep_supervision`` adds a head on the ASPP output,
upsampled ×32.
"""

from __future__ import annotations

import torch

from .encoders import get_encoder
from .modules.layers import (ASPP, ConvBNReLU, PortModule, SegmentationHead,
                             upsample)


class DeepLabV3Plus(PortModule):
    """NCHW input → fp32 logits; with ``deep_supervision`` (mask, [aux])."""

    def __init__(self, encoder_name: str = "resnet50",
                 aspp_channels: int = 256, decoder_channels: int = 128,
                 classes: int = 1, deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.deep_supervision = dtype, deep_supervision
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.aspp = ASPP(enc_channels[5], aspp_channels, dtype=dtype)
        self.low_proj = ConvBNReLU(enc_channels[2], 48, dtype, 0.0,
                                   kernel_size=1)
        self.fuse1 = ConvBNReLU(aspp_channels + 48, decoder_channels, dtype,
                                0.0)
        self.fuse2 = ConvBNReLU(decoder_channels, decoder_channels, dtype,
                                0.0)
        self.segmentation_head = SegmentationHead(
            decoder_channels, classes, dtype=dtype, upsampling=4)
        if deep_supervision:
            self.aux_head = SegmentationHead(aspp_channels, classes,
                                             dtype=dtype, upsampling=32)

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        a = self.aspp(features[5])
        y = self.fuse2(self.fuse1([upsample(a, 8),
                                   self.low_proj(features[2])]))
        mask = self.segmentation_head(y)
        if self.deep_supervision:
            return mask, [self.aux_head(a)]
        return mask
