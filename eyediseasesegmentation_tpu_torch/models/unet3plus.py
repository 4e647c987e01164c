"""UNet 3+ with full-scale skip connections (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/unet3plus.py``: every
decoder level takes ALL encoder levels at or above it (max-pooled down to
its size) and all deeper decoder levels (bilinear up), each mapped to
``cat_channels`` by a conv-BN-ReLU, then fuses their concat. Deep
supervision adds a head on each deeper decoder level, resized to the input.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .modules.layers import (ConvBNReLU, DoubleConv, PortModule,
                             SegmentationHead, maxpool2x, resize_to)


class UNet3Plus(PortModule):
    """NCHW input → fp32 logits (N, classes, H, W); with
    ``deep_supervision`` (logits, [one head per deeper level, at the input's
    size])."""

    def __init__(self, filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 cat_channels: int = 64, classes: int = 1,
                 deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.deep_supervision = dtype, deep_supervision
        self.n_levels = n = len(filters)
        cin = 3
        for i, ch in enumerate(filters):
            self.add_module(f"enc{i}", DoubleConv(cin, ch, dtype))
            cin = ch
        fuse_ch = cat_channels * n
        # the channels of decoder level l: the fuse's, the deepest the
        # encoder's
        dec_ch = [fuse_ch] * (n - 1) + [filters[-1]]
        for level in range(n - 2, -1, -1):
            for src in range(level + 1):
                self.add_module(f"d{level}_e{src}", ConvBNReLU(
                    filters[src], cat_channels, dtype, 0.0))
            for src in range(level + 1, n):
                self.add_module(f"d{level}_d{src}", ConvBNReLU(
                    dec_ch[src], cat_channels, dtype, 0.0))
            self.add_module(f"d{level}_fuse",
                            ConvBNReLU(fuse_ch, fuse_ch, dtype, 0.0))
        self.head0 = SegmentationHead(fuse_ch, classes, dtype=dtype)
        if deep_supervision:
            for level in range(1, n):
                self.add_module(f"head{level}", SegmentationHead(
                    dec_ch[level], classes, dtype=dtype))

    def forward(self, x: torch.Tensor):
        n = self.n_levels
        encs, y = [], x
        for i in range(n):
            if i > 0:
                y = maxpool2x(y)
            y = getattr(self, f"enc{i}")(y)
            encs.append(y)
        decs = {n - 1: encs[-1]}
        for level in range(n - 2, -1, -1):
            hw = encs[level].shape[2:]
            parts = []
            for src in range(level + 1):
                f = encs[src]
                if src < level:
                    k = 2 ** (level - src)
                    f = F.max_pool2d(f, k, stride=k)
                parts.append(getattr(self, f"d{level}_e{src}")(f))
            for src in range(level + 1, n):
                parts.append(getattr(self, f"d{level}_d{src}")(
                    resize_to(decs[src], hw)))
            decs[level] = getattr(self, f"d{level}_fuse")(parts)
        d1 = self.head0(decs[0])
        if self.deep_supervision:
            return d1, [resize_to(getattr(self, f"head{level}")(decs[level]),
                                  x.shape[2:]) for level in range(1, n)]
        return d1
