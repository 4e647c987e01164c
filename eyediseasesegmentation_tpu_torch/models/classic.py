"""Classic from-scratch U-Net variants (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/classic.py``: the U-Net,
Attention U-Net, R2U-Net and R2AttU-Net of one scaffold (double-conv or
recurrent residual blocks, 2×2 max-pool down, bilinear ×2 and a
conv-BN-ReLU up, optional attention gates on the skips, a 1×1 head), and
SA-UNet (DropBlock after every encoder block, CBAM spatial attention at the
bottleneck). Every size works: no part is tied to the input's size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .modules.layers import (AttentionGate, BatchNorm, CBAMSpatial,
                             ConvBNReLU, DoubleConv, DropBlock2d, PortModule,
                             SegmentationHead, conv2d, maxpool2x, upsample2x)


class RecurrentConv(PortModule):
    """y₀ = ReLU(BN(conv(x))), then ``t`` times y = ReLU(BN(conv(x + y)))
    with the one conv and BN (in training the BN's statistics move at each
    of the t + 1 calls). The BN is flax's ``bn``; the port calls it
    ``norm``, because a ``conv`` beside a ``bn`` is a ConvBNReLU to
    ``convert.py``."""

    def __init__(self, features: int, t: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.t, self.dtype = t, dtype
        self.conv = nn.Conv2d(features, features, 3, bias=False)
        self.norm = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def step(z):
            return torch.relu(self.norm(conv2d(z, self.conv, self.dtype,
                                               padding=1)))
        y = step(x)
        for _ in range(self.t):
            y = step(x + y)
        return y


class RRCNNBlock(PortModule):
    """Residual recurrent block: a 1×1 projection (bias), two
    :class:`RecurrentConv`, and the projection added back."""

    def __init__(self, cin: int, features: int, t: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(cin, features, 1)
        self.rc1 = RecurrentConv(features, t, dtype)
        self.rc2 = RecurrentConv(features, t, dtype)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (list, tuple)):
            x = torch.cat([p.to(self.dtype) for p in x], 1)
        x1 = conv2d(x, self.proj, self.dtype)
        return x1 + self.rc2(self.rc1(x1))


class _UNetBase(PortModule):
    """The scaffold of the classic variants. NCHW input → fp32 logits.
    ``block`` is 'double' or 'rrcnn'; a field left at None takes the
    variant's default (the class attribute of the same name)."""

    filters: Sequence[int] = (64, 128, 256, 512, 1024)
    block: str = "double"
    use_attention_gate: bool = False
    drop_block_prob: float = 0.0

    def __init__(self, filters: Optional[Sequence[int]] = None,
                 classes: int = 1, block: Optional[str] = None,
                 use_attention_gate: Optional[bool] = None,
                 drop_block_prob: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        given = dict(filters=filters, block=block,
                     use_attention_gate=use_attention_gate,
                     drop_block_prob=drop_block_prob)
        for k, v in given.items():
            if v is not None:
                setattr(self, k, v)
        if self.block not in ("double", "rrcnn"):
            raise ValueError(f"Unknown block {self.block!r}")
        self.dtype, self.filters = dtype, list(self.filters)
        filters = self.filters
        cin = 3
        for i, ch in enumerate(filters):
            self.add_module(f"enc{i}", self._block(cin, ch))
            if self.drop_block_prob > 0:
                self.add_module(f"enc{i}_db",
                                DropBlock2d(self.drop_block_prob))
            cin = ch
        if self.drop_block_prob > 0:
            self.bottleneck_sa = CBAMSpatial(dtype=dtype)
        for i, ch in enumerate(reversed(filters[:-1])):
            self.add_module(f"up{i}_conv", ConvBNReLU(cin, ch, dtype, 0.0))
            if self.use_attention_gate:
                self.add_module(f"gate{i}", AttentionGate(
                    ch, ch, max(ch // 2, 8), dtype=dtype))
            self.add_module(f"dec{i}", self._block(2 * ch, ch))
            cin = ch
        self.segmentation_head = SegmentationHead(cin, classes, dtype=dtype,
                                                  kernel_size=1)

    def _block(self, cin: int, ch: int) -> nn.Module:
        if self.block == "rrcnn":
            return RRCNNBlock(cin, ch, dtype=self.dtype)
        return DoubleConv(cin, ch, dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, y = [], x
        n = len(self.filters)
        for i in range(n):
            y = getattr(self, f"enc{i}")(y)
            if self.drop_block_prob > 0:
                y = getattr(self, f"enc{i}_db")(y)
            if i < n - 1:
                skips.append(y)
                y = maxpool2x(y)
        if self.drop_block_prob > 0:
            y = self.bottleneck_sa(y)
        for i in range(n - 1):
            y = getattr(self, f"up{i}_conv")(upsample2x(y))
            skip = skips[-(i + 1)]
            if self.use_attention_gate:
                skip = getattr(self, f"gate{i}")(y, skip)
            y = getattr(self, f"dec{i}")([y, skip])
        return self.segmentation_head(y)


class ClassicUNet(_UNetBase):
    pass


class AttUNet(_UNetBase):
    use_attention_gate = True


class R2UNet(_UNetBase):
    block = "rrcnn"


class R2AttUNet(_UNetBase):
    block = "rrcnn"
    use_attention_gate = True


class SAUnet(_UNetBase):
    filters = (16, 32, 64, 128)
    drop_block_prob = 0.1
