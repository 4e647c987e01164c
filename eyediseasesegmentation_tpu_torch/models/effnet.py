"""EfficientNet / MobileNetV3 / DenseNet feature-pyramid encoders (torch,
NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/effnet.py``. Every
encoder returns the 6-level pyramid ``[x, /2, /4, /8, /16, /32]``. The
stride-2 convs of EfficientNet and MobileNetV3 pad as flax's ``"SAME"``
does, (0, 1) for a 3×3 and (1, 2) for a 5×5 on an even map
(``layers.conv2d_same``); the DenseNet stem pads 3 on every side. MBConv
keeps flax's auto-names (``Conv_0``, ``BatchNorm_0``, ``SEBlock_0``, ...),
which shift by one when ``expand`` is 1: its first conv is then the
depthwise one.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules.layers import (BatchNorm, PortModule, SEBlock, conv2d,
                             conv2d_same)

# EfficientNet-B0's stages: (expand, channels, repeats, stride, kernel)
_EFFNET_B0 = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
# variant → (width multiplier, depth multiplier)
_EFFNET_SCALE = {"b0": (1.0, 1.0), "b2": (1.1, 1.2), "b4": (1.4, 1.8)}
# MobileNetV3's blocks: (features, expand, kernel, stride)
_MOBILENETV3 = [(16, 1, 3, 1), (24, 4, 3, 2), (24, 3, 3, 1),
                (40, 3, 5, 2), (40, 3, 5, 1),
                (80, 6, 3, 2), (80, 2, 3, 1), (112, 6, 3, 1),
                (160, 6, 5, 2), (160, 6, 5, 1)]


def _round_filters(f, mult):
    f *= mult
    new = max(8, int(f + 4) // 8 * 8)
    if new < 0.9 * f:
        new += 8
    return int(new)


def _activation(name: str):
    return F.silu if name == "silu" else F.hardswish


class MBConv(PortModule):
    """Mobile inverted bottleneck: 1×1 expand (skipped at ``expand`` 1) →
    depthwise ``kernel``² (stride, SAME) → squeeze-excite over the expanded
    channels at reduction ``1 / se_ratio`` → 1×1 project, each conv with BN,
    the first two activated (silu, or hard-swish for MobileNetV3); a residual
    where the shape is kept."""

    def __init__(self, cin: int, features: int, expand: int = 6,
                 kernel: int = 3, strides: int = 1, se_ratio: float = 0.25,
                 activation: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.strides, self.expand = dtype, strides, expand
        self.act = _activation(activation)
        self.residual = strides == 1 and cin == features
        mid = cin * expand
        convs = []
        if expand != 1:
            convs.append(nn.Conv2d(cin, mid, 1, bias=False))
        convs.append(nn.Conv2d(mid, mid, kernel, groups=mid, bias=False))
        convs.append(nn.Conv2d(mid, features, 1, bias=False))
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}",
                            BatchNorm(conv.out_channels, dtype))
        self.use_se = se_ratio > 0
        if self.use_se:
            self.SEBlock_0 = SEBlock(mid, dtype=dtype,
                                     reduction=int(1 / se_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, y, i = self.dtype, x, 0
        if self.expand != 1:
            y = self.act(self.BatchNorm_0(conv2d(y, self.Conv_0, dt)))
            i = 1
        y = conv2d_same(y, getattr(self, f"Conv_{i}"), dt, self.strides)
        y = self.act(getattr(self, f"BatchNorm_{i}")(y))
        if self.use_se:
            y = self.SEBlock_0(y)
        y = conv2d(y, getattr(self, f"Conv_{i + 1}"), dt)
        y = getattr(self, f"BatchNorm_{i + 1}")(y)
        return y + x if self.residual else y


class EfficientNetEncoder(PortModule):
    """EfficientNet-b0 / b2 / b4: a 3×3/2 SAME stem with BN and silu, then
    ``_EFFNET_B0``'s stages widened and deepened by ``_EFFNET_SCALE``. The
    map before each stride-2 block is a pyramid level."""

    def __init__(self, variant: str = "b0",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        wmult, dmult = _EFFNET_SCALE[variant]
        cin = _round_filters(32, wmult)
        self.stem = nn.Conv2d(3, cin, 3, bias=False)
        self.stem_bn = BatchNorm(cin, dtype)
        self.blocks: List[str] = []
        for si, (expand, ch, reps, stride, kernel) in enumerate(_EFFNET_B0):
            ch = _round_filters(ch, wmult)
            for i in range(int(math.ceil(reps * dmult))):
                name = f"stage{si}_block{i}"
                self.add_module(name, MBConv(
                    cin, ch, expand, kernel, stride if i == 0 else 1,
                    dtype=dtype))
                self.blocks.append(name)
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = F.silu(self.stem_bn(conv2d_same(x, self.stem, self.dtype, 2)))
        for name in self.blocks:
            block = getattr(self, name)
            if block.strides == 2:
                feats.append(y)
            y = block(y)
        feats.append(y)
        return feats


class MobileNetV3Encoder(PortModule):
    """A compact MobileNetV3-large-style encoder: a 3×3/2 SAME stem with BN
    and hard-swish, then ``_MOBILENETV3``'s MBConv blocks (hard-swish). The
    map before each stride-2 block is a pyramid level."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(3, 16, 3, bias=False)
        self.stem_bn = BatchNorm(16, dtype)
        cin = 16
        for i, (ch, expand, kernel, stride) in enumerate(_MOBILENETV3):
            self.add_module(f"block{i}", MBConv(
                cin, ch, expand, kernel, stride, activation="hardswish",
                dtype=dtype))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = F.hardswish(self.stem_bn(conv2d_same(x, self.stem, self.dtype,
                                                 2)))
        for i in range(len(_MOBILENETV3)):
            block = getattr(self, f"block{i}")
            if block.strides == 2:
                feats.append(y)
            y = block(y)
        feats.append(y)
        return feats


class DenseBlock(PortModule):
    """``layers`` × (BN → ReLU → 1×1 to 4·growth → BN → ReLU → 3×3 to
    ``growth``), each output concatenated to the block's running input."""

    def __init__(self, cin: int, layers: int, growth: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.layers = dtype, layers
        for i in range(layers):
            self.add_module(f"bn{i}a", BatchNorm(cin, dtype))
            self.add_module(f"conv{i}a",
                            nn.Conv2d(cin, 4 * growth, 1, bias=False))
            self.add_module(f"bn{i}b", BatchNorm(4 * growth, dtype))
            self.add_module(f"conv{i}b",
                            nn.Conv2d(4 * growth, growth, 3, bias=False))
            cin += growth
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for i in range(self.layers):
            y = torch.relu(getattr(self, f"bn{i}a")(x))
            y = conv2d(y, getattr(self, f"conv{i}a"), dt)
            y = torch.relu(getattr(self, f"bn{i}b")(y))
            y = conv2d(y, getattr(self, f"conv{i}b"), dt, padding=1)
            x = torch.cat([x, y], 1)
        return x


class DenseNetEncoder(PortModule):
    """DenseNet-121: 7×7/2 stem (pad 3) with BN and ReLU (the /2 level), a
    3×3/2 max-pool (pad 1), then four dense blocks; between two blocks the
    block's output is a level and a transition (BN, ReLU, 1×1 halving the
    channels, 2×2 average pool) follows."""

    def __init__(self, block_layers: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.n_blocks = dtype, len(block_layers)
        self.stem = nn.Conv2d(3, 64, 7, bias=False)
        self.stem_bn = BatchNorm(64, dtype)
        cin = 64
        for i, layers in enumerate(block_layers):
            block = DenseBlock(cin, layers, growth, dtype=dtype)
            self.add_module(f"dense{i}", block)
            cin = block.out_channels
            if i < self.n_blocks - 1:
                self.add_module(f"trans{i}_bn", BatchNorm(cin, dtype))
                self.add_module(f"trans{i}_conv",
                                nn.Conv2d(cin, cin // 2, 1, bias=False))
                cin //= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.dtype
        y = torch.relu(self.stem_bn(conv2d(x, self.stem, dt, 2, 3)))
        feats = [x, y]
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for i in range(self.n_blocks):
            y = getattr(self, f"dense{i}")(y)
            if i < self.n_blocks - 1:
                feats.append(y)
                y = torch.relu(getattr(self, f"trans{i}_bn")(y))
                y = conv2d(y, getattr(self, f"trans{i}_conv"), dt)
                y = F.avg_pool2d(y, 2, stride=2)
        feats.append(y)
        return feats
