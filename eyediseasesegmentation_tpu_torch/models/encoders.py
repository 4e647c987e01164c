"""Feature-pyramid encoders (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/encoders.py``: the
generic ResNet encoder (basic or bottleneck blocks, optional squeeze-excite,
grouped 3×3 convs for the SE-ResNeXt family; ``RESNET_CONFIGS``), the
flagship's BoTSER50, an SE-ResNet50 whose layer4 is three axial-attention
blocks, the last two sharing weights (``BoTSER50_Imagenet``: three SE
bottlenecks instead), by name the EfficientNet / MobileNetV3 / DenseNet
encoders of ``effnet.py``, and the Swin pyramid (``swin_tiny``,
``swin_small``) on ``transformers.SwinTransformer``. Every encoder returns
the 6-level pyramid ``[x, c0(/2), c1(/4), c2(/8), c3(/16), c4(/32)]``. A
``pretrained`` BoTSER50 (the ``_Imagenet`` configs) freezes the BatchNorms
of its stem and layers 1-3: they normalise with their running statistics
in training too and never update them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .effnet import (_EFFNET_SCALE, DenseNetEncoder, EfficientNetEncoder,
                     MobileNetV3Encoder, _round_filters)
from .modules.axial import AxialAttentionBlock
from .modules.layers import (BatchNorm, PortModule, SEBlock, conv2d,
                             conv2d_same, remat)
from .transformers import SWIN_CONFIGS, SwinTransformer


class BasicBlock(PortModule):
    """3×3 (stride, pad 1) → 3×3 → optional squeeze-excite, with a 1×1
    projection shortcut where the shape changes (resnet18 / resnet34)."""

    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1,
                 use_se: bool = False, frozen_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        self.conv1 = nn.Conv2d(cin, features, 3, bias=False)
        self.bn1 = BatchNorm(features, dtype, frozen=frozen_bn)
        self.conv2 = nn.Conv2d(features, features, 3, bias=False)
        self.bn2 = BatchNorm(features, dtype, frozen=frozen_bn)
        if use_se:
            self.se = SEBlock(features, dtype=dtype)
        self.has_down = cin != features or strides != 1
        if self.has_down:
            self.down_conv = nn.Conv2d(cin, features, 1, bias=False)
            self.down_bn = BatchNorm(features, dtype, frozen=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(conv2d(x, self.conv1, dt, self.strides, 1)))
        y = self.bn2(conv2d(y, self.conv2, dt, padding=1))
        if hasattr(self, "se"):
            y = self.se(y)
        if self.has_down:
            x = self.down_bn(conv2d(x, self.down_conv, dt,
                                    stride=self.strides))
        return torch.relu(y + x)


class Bottleneck(PortModule):
    """Bottleneck: 1×1 → 3×3 (stride, pad 1, ``groups``) → 1×1 to
    ``out_features`` (0: 4 × ``features``) → optional squeeze-excite, with
    a 1×1 projection shortcut where the shape changes."""

    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1,
                 groups: int = 1, use_se: bool = True,
                 frozen_bn: bool = False, out_features: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        out_ch = out_features or features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features, dtype, frozen=frozen_bn)
        self.conv2 = nn.Conv2d(features, features, 3, bias=False,
                               groups=groups)
        self.bn2 = BatchNorm(features, dtype, frozen=frozen_bn)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch, dtype, frozen=frozen_bn)
        if use_se:
            self.se = SEBlock(out_ch, dtype=dtype)
        self.has_down = cin != out_ch or strides != 1
        if self.has_down:
            self.down_conv = nn.Conv2d(cin, out_ch, 1, bias=False)
            self.down_bn = BatchNorm(out_ch, dtype, frozen=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(conv2d(x, self.conv1, dt)))
        y = torch.relu(self.bn2(conv2d(y, self.conv2, dt, self.strides, 1)))
        y = self.bn3(conv2d(y, self.conv3, dt))
        if hasattr(self, "se"):
            y = self.se(y)
        if self.has_down:
            x = self.down_bn(conv2d(x, self.down_conv, dt,
                                    stride=self.strides))
        return torch.relu(y + x)


class ResNetEncoder(PortModule):
    """ResNet-family encoder with the plain stem: 7×7/2 conv with pad 3,
    BN, ReLU (the /2 feature), then a 3×3/2 max-pool with pad 1, then
    ``num_stages`` stages of ``block`` ('basic' or 'bottleneck'). A
    bottleneck's inner width is ``width_factor`` × the stage's planes (2.0
    with ``groups`` 32: the ResNeXt-32x4d family). ``remat``: each block is
    recomputed in the backward in training (``layers.remat``)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block: str = "bottleneck", use_se: bool = False,
                 groups: int = 1, num_stages: int = 4,
                 frozen_bn: bool = False, width_factor: float = 1.0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"Unknown ResNet block {block!r}")
        self.dtype, self.remat = dtype, remat
        exp = Bottleneck.expansion if block == "bottleneck" else 1
        self.out_channels = [3, 64] + [64 * (2 ** i) * exp
                                       for i in range(num_stages)]
        self.stem_conv = nn.Conv2d(3, 64, 7, bias=False)
        self.stem_bn = BatchNorm(64, dtype, frozen=frozen_bn)
        self.block_names: List[List[str]] = []
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes[:num_stages]):
            planes = 64 * (2 ** stage)
            names = []
            for i in range(n_blocks):
                name = f"layer{stage + 1}_block{i}"
                strides = 2 if (i == 0 and stage > 0) else 1
                if block == "bottleneck":
                    mod = Bottleneck(
                        cin, int(planes * width_factor), strides=strides,
                        groups=groups, use_se=use_se, frozen_bn=frozen_bn,
                        out_features=planes * exp, dtype=dtype)
                else:
                    mod = BasicBlock(cin, planes, strides=strides,
                                     use_se=use_se, frozen_bn=frozen_bn,
                                     dtype=dtype)
                self.add_module(name, mod)
                cin = planes * exp
                names.append(name)
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = conv2d(x, self.stem_conv, self.dtype, stride=2, padding=3)
        y = torch.relu(self.stem_bn(y))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for names in self.block_names:
            for name in names:
                y = remat(getattr(self, name), y, enabled=self.remat)
            feats.append(y)
        return feats


class BoTSER50Encoder(PortModule):
    """SE-ResNet50 stem and layers 1-3, then layer4. With ``use_axial``:
    ``layer4_first`` (1024→2048, downsampling, dim 2·base_dim) and
    ``layer4_shared`` applied twice (one module, shared weights: in training
    its BatchNorm statistics move twice per step, as in flax). Without:
    three SE bottlenecks ``layer4_block{0,1,2}`` (512 inner, 2048 out, the
    first with stride 2), which JAX substitutes for the reference's dead
    branch. ``pretrained`` freezes the BatchNorms of the stem and layers 1-3
    (never layer4's). ``remat``: each SE bottleneck of layers 1-3 and each
    axial block call (the shared block's two calls apart) is recomputed in
    the backward in training; the bottlenecks of the ``use_axial=False``
    layer4 are not, as in JAX."""

    out_channels: Tuple[int, ...] = (3, 64, 256, 512, 1024, 2048)

    def __init__(self, base_dim: int = 32, pretrained: bool = False,
                 use_axial: bool = True, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_axial, self.remat = use_axial, remat
        self.seresnet = ResNetEncoder(stage_sizes=(3, 4, 6, 3), use_se=True,
                                      num_stages=3, frozen_bn=pretrained,
                                      remat=remat, dtype=dtype)
        if use_axial:
            self.layer4_first = AxialAttentionBlock(
                1024, 2048, down_sample=True, dim=base_dim * 2, heads=8,
                dtype=dtype)
            self.layer4_shared = AxialAttentionBlock(
                2048, 2048, down_sample=False, dim=base_dim, heads=8,
                dtype=dtype)
        else:
            for i in range(3):
                self.add_module(f"layer4_block{i}", Bottleneck(
                    1024 if i == 0 else 2048, 512, strides=2 if i == 0 else 1,
                    use_se=True, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.seresnet(x)
        y = feats[-1]
        if self.use_axial:
            y = remat(self.layer4_first, y, enabled=self.remat)
            y = remat(self.layer4_shared, y, enabled=self.remat)
            y = remat(self.layer4_shared, y, enabled=self.remat)
        else:
            for i in range(3):
                y = getattr(self, f"layer4_block{i}")(y)
        feats.append(y)
        return feats


class SwinPyramidEncoder(PortModule):
    """The Swin backbone under the 6-level pyramid of the U-Net decoders:
    a 3×3 / 2 conv stem (flax SAME, no bias) with BN and ReLU gives the /2
    level from the input, beside the Swin stages, which give /4 to /32.
    The Swin blocks are built for an ``input_size``² input."""

    def __init__(self, variant: str = "swin_tiny", input_size: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(3, 64, 3, bias=False)
        self.stem_bn = BatchNorm(64, dtype)
        self.swin = SwinTransformer(variant, input_size=input_size,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stem = conv2d_same(x, self.stem, self.dtype, 2)
        stem = torch.relu(self.stem_bn(stem))
        return [x, stem] + self.swin(x)


# the BoTSER50 configs (JAX encoders.py ENCODER_CONFIGS); ``pretrained``
# only freezes BN statistics in training, so at eval the four axial ones are
# one network
BOTSER50_CONFIGS = {
    "BoTSER50_Axial_Imagenet": dict(pretrained=True, use_axial=True),
    "BoTSER50_Axial_Imagenet_2": dict(pretrained=True, use_axial=True),
    "BoTSER50_Axial_Imagenet_3": dict(pretrained=True, use_axial=True),
    "BoTSER50_Axial_scratch": dict(pretrained=False, use_axial=True),
    "BoTSER50_Imagenet": dict(pretrained=True, use_axial=False),
}


# the ResNet family (JAX encoders.py RESNET_CONFIGS)
RESNET_CONFIGS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block="basic"),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck"),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck"),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck"),
    "seresnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck",
                       use_se=True),
    "seresnext50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck",
                        use_se=True, groups=32, width_factor=2.0),
    "seresnext101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck",
                         use_se=True, groups=32, width_factor=2.0),
}


EFFICIENTNETS = ("efficientnet-b0", "efficientnet-b2", "efficientnet-b4")


def get_encoder(name: str, base_dim: int = 32,
                dtype: torch.dtype = torch.float32, remat: bool = False,
                input_size: int = 1024):
    """Build an encoder and its out_channels list by registry name.
    ``base_dim`` sizes BoTSER50's axial tables (32 for a 1024² input),
    ``input_size`` the Swin encoders' windows (the same from 224² up).
    ``remat`` reaches the BoTSER50 and ResNet encoders' blocks; the others
    have no such field in JAX and train as they are."""
    if name in BOTSER50_CONFIGS:
        enc = BoTSER50Encoder(base_dim=base_dim, dtype=dtype, remat=remat,
                              **BOTSER50_CONFIGS[name])
        return enc, list(enc.out_channels)
    if name in RESNET_CONFIGS:
        enc = ResNetEncoder(dtype=dtype, remat=remat, **RESNET_CONFIGS[name])
        return enc, list(enc.out_channels)
    if name in EFFICIENTNETS:
        variant = name.split("-")[1]
        w = _EFFNET_SCALE[variant][0]
        # the /2 level is stage 0's output (taken before the first stride 2)
        return (EfficientNetEncoder(variant, dtype=dtype),
                [3] + [_round_filters(c, w) for c in (16, 24, 40, 112, 320)])
    if name == "mobilenetv3":
        return MobileNetV3Encoder(dtype=dtype), [3, 16, 24, 40, 112, 160]
    if name == "densenet121":
        return DenseNetEncoder(dtype=dtype), [3, 64, 256, 512, 1024, 1024]
    if name in SWIN_CONFIGS:
        return (SwinPyramidEncoder(name, input_size, dtype),
                [3, 64] + list(SWIN_CONFIGS[name]["dims"]))
    raise KeyError(f"Unknown encoder '{name}'. Options: "
                   f"{list(BOTSER50_CONFIGS) + list(RESNET_CONFIGS)} + "
                   f"{list(EFFICIENTNETS)}, mobilenetv3, densenet121, "
                   f"{', '.join(SWIN_CONFIGS)}")
