"""FPN segmentation with a concatenation merge (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/fpn.py``: lateral 1×1
convs and the top-down pathway over c1..c4, a conv-BN-ReLU per level
upsampled to the /4 level, concatenated, fused, and a head upsampled ×4 to
the input's size.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .encoders import get_encoder
from .modules.layers import (ConvBNReLU, PortModule, SegmentationHead,
                             conv2d, upsample, upsample2x)


class FPN(PortModule):
    """NCHW input → fp32 logits (N, classes, H, W)."""

    def __init__(self, encoder_name: str = "resnet34",
                 fpn_channels: int = 128, seg_channels: int = 64,
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        for level in range(1, 5):
            self.add_module(f"lat{level}", nn.Conv2d(
                enc_channels[level + 1], fpn_channels, 1))
        for i in range(4):
            self.add_module(f"seg{i}", ConvBNReLU(fpn_channels, seg_channels,
                                                  dtype, 0.0))
        self.fuse = ConvBNReLU(4 * seg_channels, 2 * seg_channels, dtype, 0.0)
        self.segmentation_head = SegmentationHead(
            2 * seg_channels, classes, dtype=dtype, upsampling=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        features = self.encoder(x)
        p = conv2d(features[5], self.lat4, dt)
        pyramid = [p]
        for level in (3, 2, 1):     # top-down: p3, p2, p1
            p = (conv2d(features[level + 1], getattr(self, f"lat{level}"), dt)
                 + upsample2x(p))
            pyramid.insert(0, p)
        outs = []
        for i, p in enumerate(pyramid):   # p1 (/4) .. p4 (/32)
            s = getattr(self, f"seg{i}")(p)
            outs.append(upsample(s, 2 ** i) if i else s)
        return self.segmentation_head(self.fuse(outs))
