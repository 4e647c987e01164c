"""The other smp families the reference resolves by class name (torch,
NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/smp_extra.py``:
Linknet, PSPNet, DeepLabV3, PAN and MAnet over a registry encoder's 6-level
pyramid. The submodules keep flax's names, auto-names included
(``ConvTranspose_0``, ``BatchNorm_0``). Three points where a plain torch
idiom differs from flax:

* flax's ``ConvTranspose`` does not flip its kernel, so the port's
  ``nn.ConvTranspose2d`` holds the flax kernel flipped in H and W
  (``convert.py`` flips it both ways);
* PSP pools with a VALID window of ``h // g``, not an adaptive pool: at a
  /32 map of 8 the 3-grid is 4×4;
* PAN's FPA pyramid sizes its kernels by the map (``min(k, side)``), so the
  parameters depend on the input size, as flax's do; PAN takes the input
  side it is built for (``input_size``) and raises on a map that needs
  other kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoders import get_encoder
from .modules.layers import (ASPP, BatchNorm, ConvBNReLU, Dropout,
                             PortModule, SegmentationHead, conv2d, resize_to,
                             upsample2x, wide)


class _TransposeX2(PortModule):
    """ConvTranspose 4×4, stride 2, SAME (×2 exactly) + BN + ReLU (smp
    linknet's TransposeX2)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, 4, stride=2,
                                                  padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(x.to(dt), self.ConvTranspose_0.weight.to(dt),
                               None, stride=2, padding=1)
        return torch.relu(self.BatchNorm_0(y))


class Linknet(PortModule):
    """LinkNet (smp.Linknet): per decode block a 1×1 squeeze to a quarter
    (at least 16), a ×2 transposed conv and a 1×1 expand to the skip's
    width, then the skip ADDED; the last block expands to 32 with no skip."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        feats = enc_channels[1:][::-1]
        outs = feats[1:] + [32]
        self.n_blocks = len(outs)
        cin = feats[0]
        for i, out in enumerate(outs):
            mid = max(cin // 4, 16)
            self.add_module(f"block{i}_squeeze",
                            ConvBNReLU(cin, mid, dtype, 0.0, 1))
            self.add_module(f"block{i}_up", _TransposeX2(mid, mid, dtype))
            self.add_module(f"block{i}_expand",
                            ConvBNReLU(mid, out, dtype, 0.0, 1))
            cin = out
        self.segmentation_head = SegmentationHead(32, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)[1:][::-1]
        y = feats[0]
        skips = feats[1:] + [None]
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}_squeeze")(y)
            y = getattr(self, f"block{i}_up")(y)
            y = getattr(self, f"block{i}_expand")(y)
            if skips[i] is not None:
                y = y + skips[i].to(y.dtype)
        return self.segmentation_head(y)


class PSPModule(PortModule):
    """Pyramid pooling (PSPNet): for each grid size g (at most the map's
    side) a VALID average pool of window and stride ``side // g``, a 1×1
    conv-BN-ReLU to ``out_channels // len(sizes)`` and a bilinear resize
    back; the input and the branches concatenated and projected by a 1×1."""

    def __init__(self, cin: int, out_channels: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sizes = tuple(sizes)
        branch = out_channels // len(self.sizes)
        for i in range(len(self.sizes)):
            self.add_module(f"branch{i}",
                            ConvBNReLU(cin, branch, dtype, 0.0, 1))
        self.bottleneck = ConvBNReLU(cin + branch * len(self.sizes),
                                     out_channels, dtype, 0.0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        outs = [x]
        for i, s in enumerate(self.sizes):
            g = min(s, h, w)
            k = (h // g, w // g)
            p = getattr(self, f"branch{i}")(F.avg_pool2d(x, k, stride=k))
            outs.append(resize_to(p, (h, w)))
        return self.bottleneck(outs)


class PSPNet(PortModule):
    """PSPNet (smp.PSPNet): PSP pooling over the /32 feature, dropout
    (train only), a 3×3 head upsampled ×32."""

    def __init__(self, encoder_name: str = "resnet34",
                 psp_out_channels: int = 512, dropout: float = 0.2,
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.psp = PSPModule(enc_channels[5], psp_out_channels, dtype=dtype)
        self.Dropout_0 = Dropout(dropout)
        self.segmentation_head = SegmentationHead(
            psp_out_channels, classes, dtype=dtype, upsampling=32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dropout_0(self.psp(self.encoder(x)[5]))
        return self.segmentation_head(y)


class DeepLabV3(PortModule):
    """DeepLabV3 (smp.DeepLabV3): ASPP over the /32 feature, a 3×3
    conv-BN-ReLU, a head upsampled ×32 (V3+ without the low-level skip)."""

    def __init__(self, encoder_name: str = "resnet34",
                 aspp_channels: int = 256, classes: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.aspp = ASPP(enc_channels[5], aspp_channels, dtype=dtype)
        self.fuse = ConvBNReLU(aspp_channels, aspp_channels, dtype, 0.0)
        self.segmentation_head = SegmentationHead(
            aspp_channels, classes, dtype=dtype, upsampling=32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.segmentation_head(self.fuse(self.aspp(
            self.encoder(x)[5])))


def fpa_kernels(h: int, w: int) -> Tuple[int, ...]:
    """The kernels of the FPA pyramid on an h×w map: one level per 2×2
    pool while both sides are at least 2 (at most 3 levels), each of
    ``min(k, the pooled height)`` for k = 7, 5, 3."""
    kernels = []
    for k in (7, 5, 3):
        if h < 2 or w < 2:
            break
        h, w = h // 2, w // 2
        kernels.append(min(k, h))
    return tuple(kernels)


def _encoder_side(side: int) -> int:
    """The side of the /32 feature of a ``side`` input: five halvings, each
    rounding up, as the stride-2 stages of the ResNet, EfficientNet and
    MobileNetV3 encoders do (equal for any side divisible by 32)."""
    for _ in range(5):
        side = -(-side // 2)
    return side


class _FPABlock(PortModule):
    """Feature Pyramid Attention (PAN's centre): the mid 1×1 branch times
    the merged attention pyramid (2×2 average pool then a conv-BN-ReLU of
    ``kernels[i]``, per level; merged bottom-up by bilinear resizes and
    adds), plus the global-pool branch. With no level the pyramid is
    ones."""

    def __init__(self, cin: int, features: int, kernels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.kernels = features, tuple(kernels)
        self.glob = ConvBNReLU(cin, features, dtype, 0.0, 1)
        self.mid = ConvBNReLU(cin, features, dtype, 0.0, 1)
        c = cin
        for i, k in enumerate(self.kernels):
            self.add_module(f"py{i + 1}", ConvBNReLU(c, features, dtype, 0.0,
                                                     k))
            c = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        if fpa_kernels(h, w) != self.kernels:
            raise ValueError(
                f"PAN: its FPA pyramid was built with kernels "
                f"{self.kernels} and a {h}x{w} /32 map needs "
                f"{fpa_kernels(h, w)}: build it with the input size it runs "
                "at (input_size)")
        g = self.glob(x.mean((2, 3), keepdim=True))
        m = self.mid(x)
        levels, z = [], x
        for i in range(len(self.kernels)):
            z = getattr(self, f"py{i + 1}")(F.avg_pool2d(z, 2, stride=2))
            levels.append(z)
        if levels:
            u = levels[-1]
            for lower in levels[-2::-1]:
                u = resize_to(u, lower.shape[2:]) + lower
            u = resize_to(u, (h, w))
        else:
            u = torch.ones((n, self.features, h, w), dtype=x.dtype,
                           device=x.device)
        return m * u + g


class _GAUBlock(PortModule):
    """Global Attention Upsample (PAN): the low-level map's 3×3
    conv-BN-ReLU gated by the sigmoid (in fp32, then cast) of the pooled
    high-level context's 1×1 conv-BN-ReLU, plus the high-level map (1×1
    projected where its width differs) resized to the low level."""

    def __init__(self, high_channels: int, low_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.low_conv = ConvBNReLU(low_channels, features, dtype, 0.0)
        self.gate = ConvBNReLU(high_channels, features, dtype, 0.0, 1)
        if high_channels != features:
            self.high_proj = ConvBNReLU(high_channels, features, dtype, 0.0,
                                        1)

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        lo = self.low_conv(low)
        g = self.gate(high.mean((2, 3), keepdim=True))
        g = torch.sigmoid(g.to(wide(g.dtype))).to(lo.dtype)
        hi = self.high_proj(high) if hasattr(self, "high_proj") else high
        return resize_to(hi, low.shape[2:]) + lo * g


class PAN(PortModule):
    """Pyramid Attention Network (smp.PAN): FPA centre on /32, GAU decode
    blocks up to /4, a head upsampled ×4. ``input_size`` is the input side
    the FPA kernels are sized for: every side from 768 up (a /32 map of at
    least 24) gives the same kernels (7, 5, 3)."""

    def __init__(self, encoder_name: str = "resnet34",
                 decoder_channels: int = 32, classes: int = 1,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        self.fpa = _FPABlock(enc_channels[5], decoder_channels,
                             fpa_kernels(*[_encoder_side(input_size)] * 2),
                             dtype)
        for i, skip in enumerate((4, 3, 2)):
            self.add_module(f"gau{i}", _GAUBlock(
                decoder_channels, enc_channels[skip], decoder_channels,
                dtype))
        self.segmentation_head = SegmentationHead(
            decoder_channels, classes, dtype=dtype, upsampling=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        y = self.fpa(feats[5])
        for i, skip in enumerate((feats[4], feats[3], feats[2])):
            y = getattr(self, f"gau{i}")(y, skip)
        return self.segmentation_head(y)


class _PABBlock(PortModule):
    """Position attention (MAnet's centre): softmax (fp32) self-attention
    over the positions of the map, queries and keys at ``c // reduction``
    channels, values at ``c``, added to the input."""

    def __init__(self, channels: int, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ck = max(channels // reduction, 1)
        self.q = nn.Conv2d(channels, ck, 1)
        self.k = nn.Conv2d(channels, ck, 1)
        self.v = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        n, c, h, w = x.shape

        def tokens(conv):
            return conv2d(x, conv, dt).flatten(2).transpose(1, 2)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        att = torch.softmax(torch.matmul(q, k.transpose(1, 2))
                            .to(wide(dt)), dim=-1)
        y = torch.matmul(att.to(v.dtype), v)
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class _MFABBlock(PortModule):
    """Multi-scale Fusion Attention (MAnet's decode block): the input
    upsampled ×2 and scaled by the sum of two channel attentions (squeeze-
    excite of the input, ``hi``, and of the skip, ``lo``; sigmoids in fp32,
    then cast), concatenated with the skip, then two 3×3 conv-BN-ReLU.
    Without a skip neither attention acts, but ``hi``'s convs exist, as in
    flax."""

    def __init__(self, cin: int, skip_channels: int, features: int,
                 reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        sides = [("hi", cin)] + ([("lo", skip_channels)] if skip_channels
                                 else [])
        for name, c in sides:
            mid = max(c // reduction, 1)
            self.add_module(f"{name}_fc1", nn.Conv2d(c, mid, 1))
            self.add_module(f"{name}_fc2", nn.Conv2d(mid, cin, 1))
        self.conv1 = ConvBNReLU(cin + skip_channels, features, dtype, 0.0)
        self.conv2 = ConvBNReLU(features, features, dtype, 0.0)

    def _se(self, z: torch.Tensor, name: str) -> torch.Tensor:
        dt = self.dtype
        s = z.mean((2, 3), keepdim=True)
        s = torch.relu(conv2d(s, getattr(self, f"{name}_fc1"), dt))
        s = conv2d(s, getattr(self, f"{name}_fc2"), dt)
        return torch.sigmoid(s.to(wide(s.dtype))).to(z.dtype)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor]) -> torch.Tensor:
        y: List[torch.Tensor] = [upsample2x(x)]
        if skip is not None:
            att = self._se(x, "hi") + self._se(skip, "lo")
            y = [y[0] * att, skip.to(y[0].dtype)]
        return self.conv2(self.conv1(y))


class MAnet(PortModule):
    """Multi-scale Attention Net (smp.MAnet): a PAB centre on /32, then MFAB
    blocks of ``decoder_channels`` up to the input's size (the last with no
    skip), a 3×3 head."""

    def __init__(self, encoder_name: str = "resnet34",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(encoder_name, dtype=dtype)
        feats = enc_channels[1:][::-1]
        skips = feats[1:] + [0]
        self.pab = _PABBlock(feats[0], dtype=dtype)
        self.n_blocks = len(decoder_channels)
        cin = feats[0]
        for i, out in enumerate(decoder_channels):
            self.add_module(f"block{i}", _MFABBlock(cin, skips[i], out,
                                                    dtype=dtype))
            cin = out
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)[1:][::-1]
        y = self.pab(feats[0])
        skips = feats[1:] + [None]
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y, skips[i])
        return self.segmentation_head(y)
