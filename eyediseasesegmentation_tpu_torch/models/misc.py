"""The zoo's remaining families (torch, NCHW): MedT axial U-Nets,
DoubleU-Net, HED-UNet, DC-UNet, ResUNet++, the HuBMAP SE-ResNeXt101 U-Net,
HRNet and UneXt50.

Counterpart of ``eyediseasesegmentation_tpu/models/misc.py``, class by
class. The gated axial attention runs as plain ``torch`` ops with an fp32
softmax, as JAX computes it with ``einsum`` outside any kernel; it is not
kernel K1 (no folded BN, learnt scalar gates, a query width apart from the
value width). Its position tables are sized by the map it receives, so the
MedT models are built for one ``input_size`` and raise ``ValueError`` on a
map that needs another.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoders import BasicBlock, Bottleneck, ResNetEncoder, get_encoder
from .modules.layers import (ASPP, CBAM, BatchNorm, ConvBNReLU, DoubleConv,
                             PortModule, SEBlock, SegmentationHead, conv2d,
                             linear, maxpool2x, resize_to, upsample2x, wide)

GATES = ("gate_qr", "gate_kr", "gate_v", "gate_rv")


# ---------------------------------------------------------------------------
# MedT family
# ---------------------------------------------------------------------------

class GatedAxialAttention(PortModule):
    """Axial attention over (b, L, C) with learnt scalar gates on the
    position terms: logits = q·k / √dq + g_qr·(q·r_q) + g_kr·(k·r_k), output
    = g_v·(attn·v) + g_rv·(attn·r_v), then a Dense back to C. The heads are
    ``min(heads, C // 2)`` (at least 1) of value width ``C // H`` and query
    width ``max(dh // 2, 4)``, which may exceed it. The position table
    ``relative`` is (2·dq + dh, 2·``dim`` − 1), indexed by i − j + dim − 1;
    ``dim`` is the length L it is built for.

    Dtypes as in JAX: the scores turn fp32 at the division, the gated terms
    are fp32 (the gates are fp32 scalars), the softmax runs in fp32 and is
    cast back; without gates ``attn·v + attn·r_v`` stays in ``dtype``."""

    def __init__(self, dim: int, in_channels: int, heads: int = 8,
                 gated: bool = True, use_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.gated, self.use_pos, self.dtype = (dim, gated, use_pos,
                                                          dtype)
        self.heads = max(min(heads, in_channels // 2), 1)
        self.dh = max(in_channels // self.heads, 1)
        self.dq = max(self.dh // 2, 4)
        width = 2 * self.dq + self.dh
        self.to_qkv = nn.Linear(in_channels, self.heads * width, bias=False)
        self.qkv_bn = BatchNorm(self.heads * width, dtype)
        if use_pos:
            self.relative = nn.Parameter(torch.zeros(width, 2 * dim - 1))
            idx = np.arange(dim)[:, None] - np.arange(dim)[None, :] + dim - 1
            self.register_buffer("index", torch.as_tensor(idx.reshape(-1)),
                                 persistent=False)
            if gated:
                for name in GATES:
                    setattr(self, name, nn.Parameter(torch.ones(())))
        self.to_out = nn.Linear(self.heads * self.dh, in_channels,
                                bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, L, _ = x.shape
        dt, H, dq, dh = self.dtype, self.heads, self.dq, self.dh
        w = wide(dt)
        if self.use_pos and L != self.dim:
            raise ValueError(
                f"GatedAxialAttention: its position table is built for a "
                f"length of {self.dim}, got {L}: build the model with the "
                "input size it runs at (input_size)")
        qkv = linear(x, self.to_qkv, dt)
        qkv = self.qkv_bn(qkv.transpose(1, 2)).transpose(1, 2)  # over (b, L)
        qkv = qkv.reshape(b, L, H, 2 * dq + dh).transpose(1, 2)  # (b, H, L, ·)
        q, k, v = qkv.split([dq, dq, dh], -1)
        logits = torch.matmul(q, k.transpose(-1, -2)).to(w) / math.sqrt(dq)
        if self.use_pos:
            emb = self.relative[:, self.index].reshape(-1, L, L)
            r_q, r_k, r_v = emb.split([dq, dq, dh], 0)
            qr = torch.einsum("bhld,dlm->bhlm", q, r_q.to(q.dtype))
            kr = torch.einsum("bhmd,dlm->bhlm", k, r_k.to(k.dtype))
            if self.gated:
                qr, kr = qr.to(w) * self.gate_qr, kr.to(w) * self.gate_kr
            logits = logits + qr + kr
        attn = torch.softmax(logits.to(w), -1).to(dt)
        out = torch.matmul(attn, v)
        if self.use_pos:
            rv = torch.einsum("bhlm,dlm->bhld", attn, r_v.to(attn.dtype))
            if self.gated:
                out = out.to(w) * self.gate_v + rv.to(w) * self.gate_rv
            else:
                out = out + rv
        out = out.transpose(1, 2).reshape(b, L, H * dh)
        return linear(out, self.to_out, dt)


class MedTAxialBlock(PortModule):
    """Residual height + width axial block: 1×1 conv to ``features // 2``,
    BN, ReLU, gated axial attention along H (length ``side``) then W, a
    ``strides``² average pool, ReLU, 1×1 conv to ``features`` and BN, plus
    the (1×1 conv + BN) shortcut where the shape changes, then ReLU. Its
    children keep flax's auto-names."""

    def __init__(self, cin: int, features: int, side: int, heads: int = 8,
                 gated: bool = True, use_pos: bool = True, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.strides = dtype, strides
        c = features // 2
        self.Conv_0 = nn.Conv2d(cin, c, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(c, dtype)
        self.height = GatedAxialAttention(side, c, heads, gated, use_pos,
                                          dtype)
        self.width = GatedAxialAttention(side, c, heads, gated, use_pos,
                                         dtype)
        self.Conv_1 = nn.Conv2d(c, features, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features, dtype)
        self.has_shortcut = strides > 1 or cin != features
        if self.has_shortcut:
            self.Conv_2 = nn.Conv2d(cin, features, 1, bias=False)
            self.BatchNorm_2 = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.BatchNorm_0(conv2d(x, self.Conv_0, dt)))
        b, c, h, w = y.shape
        cols = self.height(y.permute(0, 3, 2, 1).reshape(b * w, h, c))
        rows = cols.reshape(b, w, h, c).transpose(1, 2).reshape(b * h, w, c)
        y = self.width(rows).reshape(b, h, w, c).permute(0, 3, 1, 2)
        if self.strides > 1:
            y = F.avg_pool2d(y, self.strides, self.strides)
        y = self.BatchNorm_1(conv2d(torch.relu(y), self.Conv_1, dt))
        sc = x
        if self.has_shortcut:
            sc = self.BatchNorm_2(conv2d(x, self.Conv_2, dt,
                                         stride=self.strides))
        return torch.relu(y + sc)


class ResAxialAttentionUNet(PortModule):
    """Axial-attention U-Net: a 7×7 / 2 and a 3×3 conv stem, four axial
    blocks (strides 1, 2, 2, 2; the width doubles at each stride), a light
    decoder (×2, conv-BN-ReLU, plus the skip), ×2 to the input's size, a
    conv-BN-ReLU and the head. Built for an ``input_size``² input (the
    position tables' lengths), unless ``use_pos`` is off."""

    def __init__(self, base: int = 32, gated: bool = True,
                 use_pos: bool = True, classes: int = 1,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem1 = ConvBNReLU(3, base, dtype, 0.0, 7, strides=2)
        self.stem2 = ConvBNReLU(base, base, dtype, 0.0)
        side, ch, widths = -(-input_size // 2), base, []
        for i, stride in enumerate((1, 2, 2, 2)):
            ch2 = ch * (2 if stride == 2 else 1)
            self.add_module(f"axial{i}", MedTAxialBlock(
                ch, ch2, side, gated=gated, use_pos=use_pos, strides=stride,
                dtype=dtype))
            side, ch = side // stride, ch2
            widths.append(ch)
        for i, skip in enumerate(reversed(widths[:-1])):
            self.add_module(f"dec{i}", ConvBNReLU(ch, skip, dtype, 0.0))
            ch = skip
        self.dec_final = ConvBNReLU(ch, base, dtype, 0.0)
        self.segmentation_head = SegmentationHead(base, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem2(self.stem1(x))
        feats = []
        for i in range(4):
            y = getattr(self, f"axial{i}")(y)
            feats.append(y)
        for i, skip in enumerate(reversed(feats[:-1])):
            y = getattr(self, f"dec{i}")(upsample2x(y)) + skip
        y = self.dec_final(upsample2x(y))
        return self.segmentation_head(y)


class MedT(PortModule):
    """Medical Transformer: a gated axial U-Net on the whole input (global
    branch) plus one on each of the ``patch_grid``² patches (local branch,
    built for ``input_size // patch_grid``), the patches cut and put back in
    row-major grid order; the two logits added."""

    def __init__(self, base: int = 16, classes: int = 1, patch_grid: int = 4,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.patch_grid = dtype, patch_grid
        self.global_branch = ResAxialAttentionUNet(
            base, gated=True, classes=classes, input_size=input_size,
            dtype=dtype)
        self.local_branch = ResAxialAttentionUNet(
            base, gated=True, classes=classes,
            input_size=input_size // patch_grid, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, H, W = x.shape
        g = self.patch_grid
        ph, pw = H // g, W // g
        patches = (x.reshape(n, c, g, ph, g, pw).permute(0, 2, 4, 1, 3, 5)
                   .reshape(n * g * g, c, ph, pw))
        local = self.local_branch(patches)
        k = local.shape[1]
        local = (local.reshape(n, g, g, k, ph, pw).permute(0, 3, 1, 4, 2, 5)
                 .reshape(n, k, H, W))
        return self.global_branch(x) + local


# ---------------------------------------------------------------------------
# DoubleU-Net
# ---------------------------------------------------------------------------

class VGGEncoder(PortModule):
    """VGG19-style encoder: stages of 3×3 conv-BN-ReLUs (``s{s}c{i}``), a
    2×2 max-pool before each stage but the first. Returns ``[x, /1, /2, /4,
    /8, /16]``."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512, 512),
                 convs_per_stage: Sequence[int] = (2, 2, 4, 4, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels = [3] + list(widths)
        self.names: List[List[str]] = []
        cin = 3
        for s, (w, n_convs) in enumerate(zip(widths, convs_per_stage)):
            names = []
            for i in range(n_convs):
                self.add_module(f"s{s}c{i}", ConvBNReLU(cin, w, dtype, 0.0))
                names.append(f"s{s}c{i}")
                cin = w
            self.names.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, y = [x], x
        for s, names in enumerate(self.names):
            if s > 0:
                y = maxpool2x(y)
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats


class DoubleUnet(PortModule):
    """Two cascaded U-Nets with ASPP at each bottleneck: the second encoder
    takes the input times the sigmoid of the first net's logits, and the
    second decoder concatenates the skips of both encoders. On ``vgg`` the
    skips are /2../16 and the last decoder step has none; on a registry
    encoder they are /2../32 and the output is resized ×2."""

    def __init__(self, encoder_name: str = "resnet50",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.vgg = dtype, encoder_name == "vgg"
        for name in ("encoder1", "encoder2"):
            if self.vgg:
                enc = VGGEncoder(dtype=dtype)
                channels = enc.out_channels
            else:
                enc, channels = get_encoder(encoder_name, dtype=dtype)
            self.add_module(name, enc)
        levels = channels[2:] if self.vgg else channels[1:]
        skips = levels[:-1][::-1]
        for net in (1, 2):
            self.add_module(f"aspp{net}", ASPP(levels[-1], 128, dtype=dtype))
            ch = 128
            for i, out in enumerate(decoder_channels):
                cin = ch + (net * skips[i] if i < len(skips) else 0)
                self.add_module(f"dec{net}_{i}",
                                ConvBNReLU(cin, out, dtype, 0.0))
                ch = out
            self.add_module(f"head{net}", SegmentationHead(ch, classes,
                                                           dtype=dtype))
        self.steps = len(decoder_channels)

    def _encode(self, encoder: nn.Module, x: torch.Tensor):
        feats = encoder(x)
        return feats[2:] if self.vgg else feats[1:]

    def _decode(self, net: int, f: List[torch.Tensor], skips, hw):
        y = getattr(self, f"aspp{net}")(f[-1])
        for i in range(self.steps):
            y = upsample2x(y)
            if i < len(skips[0]):
                y = [y] + [s[i] for s in skips]
            y = getattr(self, f"dec{net}_{i}")(y)
        if tuple(y.shape[2:]) != hw:
            y = resize_to(y, hw)
        return getattr(self, f"head{net}")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[2:])
        f1 = self._encode(self.encoder1, x)
        skips1 = f1[:-1][::-1]
        out1 = self._decode(1, f1, [skips1], hw)
        f2 = self._encode(self.encoder2,
                          x * torch.sigmoid(out1.to(self.dtype)))
        return self._decode(2, f2, [skips1, f2[:-1][::-1]], hw)


# ---------------------------------------------------------------------------
# HED-UNet
# ---------------------------------------------------------------------------

class _HEDBlock(PortModule):
    """HED-UNet conv block: ``double`` (two conv-BN-ReLUs), ``res`` (conv-BN-
    ReLU, conv, BN, plus a 1×1 shortcut, ReLU) or ``dense`` (two growth
    conv-BN-ReLUs of ``max(features // 2, 8)`` on the running concat, then
    a 1×1 conv-BN-ReLU projection of ``[x, a, b]``)."""

    def __init__(self, cin: int, features: int, kind: str = "double",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        if kind == "double":
            self.DoubleConv_0 = DoubleConv(cin, features, dtype)
        elif kind == "res":
            self.c1 = ConvBNReLU(cin, features, dtype, 0.0)
            self.c2 = nn.Conv2d(features, features, 3, bias=False)
            self.bn = BatchNorm(features, dtype)
            self.sc = nn.Conv2d(cin, features, 1, bias=False)
        else:
            g = max(features // 2, 8)
            self.d1 = ConvBNReLU(cin, g, dtype, 0.0)
            self.d2 = ConvBNReLU(cin + g, g, dtype, 0.0)
            self.proj = ConvBNReLU(cin + 2 * g, features, dtype, 0.0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "double":
            return self.DoubleConv_0(x)
        if self.kind == "res":
            dt = self.dtype
            y = self.bn(conv2d(self.c1(x), self.c2, dt, padding=1))
            return torch.relu(y + conv2d(x, self.sc, dt))
        a = self.d1(x)
        b = self.d2([x, a])
        return self.proj([x, a, b])


class HEDUNet(PortModule):
    """U-Net whose decoder predicts ``2·classes`` maps (segmentation, then
    edge) at every scale, each resized in fp32 to the input's size; a 1×1
    conv of their concat gives one weight per scale, softmaxed over the
    scales in fp32, and the weighted sum's segmentation channels are the
    output. ``deep_supervision`` also returns the segmentation channels of
    every scale but the finest."""

    def __init__(self, base: int = 16, depth: int = 4, classes: int = 1,
                 block: str = "double", deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depth, self.classes = dtype, depth, classes
        self.deep_supervision = deep_supervision
        cin = 3
        for i in range(depth):
            self.add_module(f"enc{i}",
                            _HEDBlock(cin, base * 2 ** i, block, dtype))
            cin = base * 2 ** i
        self.bottleneck = _HEDBlock(cin, base * 2 ** depth, block, dtype)
        ch = base * 2 ** depth
        for i in range(depth - 1, -1, -1):
            f = base * 2 ** i
            self.add_module(f"dec{i}", _HEDBlock(ch + f, f, block, dtype))
            self.add_module(f"pred{i}", nn.Conv2d(f, 2 * classes, 1))
            ch = f
        self.merge_att = nn.Conv2d(depth * 2 * classes, depth, 1)

    def forward(self, x: torch.Tensor):
        dt, w = self.dtype, wide(self.dtype)
        hw = tuple(x.shape[2:])
        skips, y = [], x
        for i in range(self.depth):
            y = getattr(self, f"enc{i}")(y)
            skips.append(y)
            y = maxpool2x(y)
        y = self.bottleneck(y)
        preds = []
        for i in range(self.depth - 1, -1, -1):
            y = torch.cat([upsample2x(y), skips[i]], 1)
            y = getattr(self, f"dec{i}")(y)
            p = conv2d(y, getattr(self, f"pred{i}"), dt)
            preds.append(resize_to(p.to(w), hw))
        att = conv2d(torch.cat(preds, 1).to(dt), self.merge_att, dt)
        att = torch.softmax(att.to(w), 1)
        merged = torch.einsum("nschw,nshw->nchw", torch.stack(preds, 1), att)
        seg = merged[:, :self.classes]
        if self.deep_supervision:
            return seg, [p[:, :self.classes] for p in preds[:-1]]
        return seg


# ---------------------------------------------------------------------------
# DC-UNet
# ---------------------------------------------------------------------------

class DCBlock(PortModule):
    """Two parallel chains of three 3×3 conv-BN-ReLUs (``w // 2``, ``w //
    2``, ``w`` with ``w = max(features // 2, 8)``), every output of both
    concatenated, a 1×1 conv + BN, plus a 1×1 conv + BN shortcut, ReLU."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        w = max(features // 2, 8)
        for chain in ("a", "b"):
            c = cin
            for i, f in enumerate((w // 2, w // 2, w)):
                self.add_module(f"{chain}{i}", ConvBNReLU(c, f, dtype, 0.0))
                c = f
        self.proj = nn.Conv2d(4 * w, features, 1, bias=False)
        self.proj_bn = BatchNorm(features, dtype)
        self.sc = nn.Conv2d(cin, features, 1, bias=False)
        self.sc_bn = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, outs = self.dtype, []
        for chain in ("a", "b"):
            y = x
            for i in range(3):
                y = getattr(self, f"{chain}{i}")(y)
                outs.append(y)
        y = self.proj_bn(conv2d(torch.cat(outs, 1), self.proj, dt))
        return torch.relu(y + self.sc_bn(conv2d(x, self.sc, dt)))


class DcUnet(PortModule):
    """Dual-channel U-Net: a ``DCBlock`` per level, max-pools down,
    ×2 + skip concat + ``DCBlock`` up, a 1×1 head."""

    def __init__(self, filters: Sequence[int] = (32, 64, 128, 256),
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.levels = dtype, len(filters)
        cin = 3
        for i, f in enumerate(filters):
            self.add_module(f"enc{i}", DCBlock(cin, f, dtype))
            cin = f
        for i, f in enumerate(reversed(filters[:-1])):
            self.add_module(f"dec{i}", DCBlock(cin + f, f, dtype))
            cin = f
        self.segmentation_head = SegmentationHead(cin, classes, dtype=dtype,
                                                  kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, y = [], x
        for i in range(self.levels):
            y = getattr(self, f"enc{i}")(y)
            if i < self.levels - 1:
                skips.append(y)
                y = maxpool2x(y)
        for i in range(self.levels - 1):
            y = torch.cat([upsample2x(y), skips[-(i + 1)]], 1)
            y = getattr(self, f"dec{i}")(y)
        return self.segmentation_head(y)


# ---------------------------------------------------------------------------
# ResUNet++
# ---------------------------------------------------------------------------

class ResUnetPlusPlus(PortModule):
    """ResUNet++: residual units (stride 2 down), squeeze-excited skips,
    an ASPP bridge, ×2 + skip concat + residual unit up, an ASPP and a 1×1
    head."""

    def __init__(self, filters: Sequence[int] = (16, 32, 64, 128),
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.filters = dtype, list(filters)
        f = self.filters
        self._res("enc0", 3, f[0], 1)
        for i in range(1, len(f)):
            self.add_module(f"se{i}", SEBlock(f[i - 1], dtype=dtype))
            self._res(f"enc{i}", f[i - 1], f[i], 2)
        self.bridge = ASPP(f[-1], f[-1], dtype=dtype)
        ch = f[-1]
        for i in range(len(f) - 1):
            skip = f[-(i + 2)]
            self._res(f"dec{i}", ch + skip, skip, 1)
            ch = skip
        self.out_aspp = ASPP(ch, f[0], dtype=dtype)
        self.segmentation_head = SegmentationHead(f[0], classes, dtype=dtype,
                                                  kernel_size=1)

    def _res(self, name: str, cin: int, f: int, strides: int) -> None:
        self.add_module(f"{name}_sc", nn.Conv2d(cin, f, 1, bias=False))
        self.add_module(f"{name}_c1", ConvBNReLU(cin, f, self.dtype, 0.0,
                                                 strides=strides))
        self.add_module(f"{name}_c2", nn.Conv2d(f, f, 3, bias=False))
        self.add_module(f"{name}_bn", BatchNorm(f, self.dtype))

    def _res_block(self, y: torch.Tensor, name: str) -> torch.Tensor:
        dt = self.dtype
        c1 = getattr(self, f"{name}_c1")
        sc = conv2d(y, getattr(self, f"{name}_sc"), dt, stride=c1.strides)
        z = conv2d(c1(y), getattr(self, f"{name}_c2"), dt, padding=1)
        return torch.relu(getattr(self, f"{name}_bn")(z) + sc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        y = self._res_block(x, "enc0")
        for i in range(1, len(self.filters)):
            skips.append(getattr(self, f"se{i}")(y))
            y = self._res_block(y, f"enc{i}")
        y = self.bridge(y)
        for i in range(len(self.filters) - 1):
            y = torch.cat([upsample2x(y), skips[-(i + 1)]], 1)
            y = self._res_block(y, f"dec{i}")
        return self.segmentation_head(self.out_aspp(y))


# ---------------------------------------------------------------------------
# HuBMAP UNET_SERESNEXT101
# ---------------------------------------------------------------------------

class UnetSEResNext101(PortModule):
    """SE-ResNeXt101 encoder, conv-BN-ReLU + CBAM decode steps, a
    hypercolumn of every decoder level resized to the input's size, a
    conv-BN-ReLU and a 1×1 conv to fp32 logits. ``clf_head``: mean of c4,
    Dense 256, ELU, Dense to fp32 class logits; with ``clf_threshold`` an
    eval forward sets the logits of an image whose class probability is
    not above it to −100. ``deep_supervision`` adds heads on the four inner
    levels [/16../2]. Returns ``(logits, deeps, clf)``, ``(logits,
    clf)``, ``(logits, deeps)`` or the logits."""

    def __init__(self, decoder_channels: int = 64, classes: int = 1,
                 clf_head: bool = True, clf_threshold: Optional[float] = None,
                 deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.clf_head = dtype, clf_head
        self.clf_threshold = clf_threshold
        self.deep_supervision = deep_supervision
        self.encoder, ch = get_encoder("seresnext101", dtype=dtype)
        dc = decoder_channels
        if clf_head:
            self.Dense_0 = nn.Linear(ch[5], 256)
            self.Dense_1 = nn.Linear(256, classes)
        for name, cin in (("center", ch[5]), ("dec4", ch[5] + dc),
                          ("dec3", ch[4] + dc), ("dec2", ch[3] + dc),
                          ("dec1", ch[2] + dc), ("dec0", ch[1] + dc)):
            self.add_module(f"{name}_conv", ConvBNReLU(cin, dc, dtype, 0.0))
            self.add_module(f"{name}_cbam", CBAM(dc, dtype=dtype))
        self.hyper_conv = ConvBNReLU(5 * dc, dc, dtype, 0.0)
        self.final = nn.Conv2d(dc, classes, 1)
        if deep_supervision:
            for i in range(4):
                self.add_module(f"deep{i}", SegmentationHead(dc, classes,
                                                             dtype=dtype))

    def _decode(self, name: str, t, up: bool = True) -> torch.Tensor:
        t = getattr(self, f"{name}_cbam")(getattr(self, f"{name}_conv")(t))
        return upsample2x(t) if up else t

    def forward(self, x: torch.Tensor):
        dt, w = self.dtype, wide(self.dtype)
        hw = tuple(x.shape[2:])
        _, c0, c1, c2, c3, c4 = self.encoder(x)
        clf = None
        if self.clf_head:
            s = F.elu(linear(c4.mean((2, 3)), self.Dense_0, dt))
            clf = linear(s, self.Dense_1, dt).to(w)
        y5 = self._decode("center", c4, up=False)
        y4 = self._decode("dec4", [c4, y5])
        y3 = self._decode("dec3", [c3, y4])
        y2 = self._decode("dec2", [c2, y3])
        y1 = self._decode("dec1", [c1, y2])
        y0 = self._decode("dec0", [c0, y1])
        hyper = self.hyper_conv([resize_to(t, hw)
                                 for t in (y0, y1, y2, y3, y4)])
        logits = conv2d(hyper, self.final, dt).to(w)
        if (not self.training and self.clf_head
                and self.clf_threshold is not None):
            keep = (torch.sigmoid(clf) > self.clf_threshold).to(w)
            keep = keep[:, :, None, None]
            logits = logits * keep + (-100.0) * (1 - keep)
        if self.deep_supervision:
            deeps = [getattr(self, f"deep{i}")(t)
                     for i, t in enumerate((y4, y3, y2, y1))]
            return (logits, deeps, clf) if self.clf_head else (logits, deeps)
        return (logits, clf) if self.clf_head else logits


# ---------------------------------------------------------------------------
# HRNetV2
# ---------------------------------------------------------------------------

class _HRFuse(PortModule):
    """Full cross-resolution fusion: branch ``i`` receives every other
    branch ``j``, a lower resolution through a 1×1 conv + BN and a bilinear
    resize, a higher one through a chain of 3×3 / 2 convs (pad 1) + BN with
    ReLU between them; the sum, then ReLU."""

    def __init__(self, widths: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.widths = dtype, list(widths)
        for i, wi in enumerate(widths):
            for j, wj in enumerate(widths):
                if j > i:
                    self.add_module(f"f{j}to{i}_conv",
                                    nn.Conv2d(wj, wi, 1, bias=False))
                    self.add_module(f"f{j}to{i}_bn", BatchNorm(wi, dtype))
                for k in range(i - j):
                    out = wi if k == i - j - 1 else wj
                    self.add_module(f"f{j}to{i}_conv{k}",
                                    nn.Conv2d(wj, out, 3, bias=False))
                    self.add_module(f"f{j}to{i}_bn{k}", BatchNorm(out, dtype))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        dt, fused = self.dtype, []
        for i in range(len(xs)):
            acc = xs[i]
            for j in range(len(xs)):
                if i == j:
                    continue
                s = xs[j]
                if j > i:
                    s = getattr(self, f"f{j}to{i}_bn")(
                        conv2d(s, getattr(self, f"f{j}to{i}_conv"), dt))
                    s = resize_to(s, xs[i].shape[2:])
                for k in range(i - j):
                    s = conv2d(s, getattr(self, f"f{j}to{i}_conv{k}"), dt,
                               stride=2, padding=1)
                    s = getattr(self, f"f{j}to{i}_bn{k}")(s)
                    if k < i - j - 1:
                        s = torch.relu(s)
                acc = acc + s
            fused.append(torch.relu(acc))
        return fused


class _HRModule(PortModule):
    """One HRNet exchange module: ``n_blocks`` BasicBlocks (no SE) per
    branch, then the full fusion."""

    def __init__(self, widths: Sequence[int], n_blocks: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.widths, self.n_blocks = list(widths), n_blocks
        for i, w in enumerate(widths):
            for b in range(n_blocks):
                self.add_module(f"b{i}_blk{b}", BasicBlock(w, w, dtype=dtype))
        self.fuse = _HRFuse(widths, dtype)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.n_blocks):
                x = getattr(self, f"b{i}_blk{b}")(x)
            ys.append(x)
        return self.fuse(ys)


class HRNet(PortModule):
    """HRNetV2 segmentation: two 3×3 / 2 conv stems (/4), four bottlenecks
    (64 → 256, no SE), a four-branch pyramid [C, 2C, 4C, 8C] with 1 / 4 / 3
    exchange modules in stages 2 / 3 / 4 (a stride-2 transition adds each
    new branch), then every branch resized to /4 and concatenated, a 1×1
    conv-BN-ReLU and a head upsampled ×4."""

    def __init__(self, width: int = 18, classes: int = 1,
                 stage_modules: Sequence[int] = (1, 4, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, w = dtype, width
        widths = [w, 2 * w, 4 * w, 8 * w]
        self.stage_modules = list(stage_modules)
        self.stem1 = ConvBNReLU(3, 64, dtype, 0.0, strides=2)
        self.stem2 = ConvBNReLU(64, 64, dtype, 0.0, strides=2)
        for b in range(4):
            self.add_module(f"layer1_blk{b}", Bottleneck(
                64 if b == 0 else 256, 64, use_se=False, dtype=dtype))
        self.trans1_b0 = ConvBNReLU(256, widths[0], dtype, 0.0)
        self.trans1_b1 = ConvBNReLU(256, widths[1], dtype, 0.0, strides=2)
        n = 2
        for stage, n_modules in enumerate(self.stage_modules):
            if stage > 0:
                self.add_module(f"trans{stage + 1}", ConvBNReLU(
                    widths[n - 1], widths[n], dtype, 0.0, strides=2))
                n += 1
            for m in range(n_modules):
                self.add_module(f"stage{stage + 2}_m{m}",
                                _HRModule(widths[:n], dtype=dtype))
        self.head_conv = ConvBNReLU(sum(widths), sum(widths), dtype, 0.0, 1)
        self.segmentation_head = SegmentationHead(sum(widths), classes,
                                                  dtype=dtype, upsampling=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem2(self.stem1(x))
        for b in range(4):
            y = getattr(self, f"layer1_blk{b}")(y)
        branches = [self.trans1_b0(y), self.trans1_b1(y)]
        for stage, n_modules in enumerate(self.stage_modules):
            if stage > 0:
                branches.append(
                    getattr(self, f"trans{stage + 1}")(branches[-1]))
            for m in range(n_modules):
                branches = getattr(self, f"stage{stage + 2}_m{m}")(branches)
        hw = branches[0].shape[2:]
        y = self.head_conv([branches[0]] + [resize_to(b, hw)
                                            for b in branches[1:]])
        return self.segmentation_head(y)


# ---------------------------------------------------------------------------
# UneXt50
# ---------------------------------------------------------------------------

class UneXt50(PortModule):
    """ResNeXt-50 trunk as JAX builds it (``ResNetEncoder`` with 32 groups
    at width factor 1.0, no SE: 2 channels a group in stage 1), ASPP on c4,
    ×2 + skip concat + conv-BN-ReLU up to /2, an FPN hypercolumn (each
    deeper decoder level 1×1 to 16 channels and resized to /2), a
    conv-BN-ReLU to 64 and a head upsampled ×2."""

    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(stage_sizes=(3, 4, 6, 3),
                                     block="bottleneck", groups=32,
                                     dtype=dtype)
        ch = self.encoder.out_channels
        self.aspp = ASPP(ch[5], 256, dtype=dtype)
        cin = 256
        for i, (skip, out) in enumerate(zip(ch[4:0:-1], decoder_channels)):
            self.add_module(f"dec{i}", ConvBNReLU(cin + skip, out, dtype,
                                                  0.0))
            cin = out
        for i, out in enumerate(decoder_channels[:-1]):
            self.add_module(f"fpn{i}", nn.Conv2d(out, 16, 1))
        self.fuse = ConvBNReLU(cin + 16 * (len(decoder_channels) - 1), 64,
                               dtype, 0.0)
        self.segmentation_head = SegmentationHead(64, classes, dtype=dtype,
                                                  upsampling=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        y = self.aspp(feats[5])
        hyper = []
        for i, skip in enumerate(feats[4:0:-1]):
            y = getattr(self, f"dec{i}")([upsample2x(y), skip])
            hyper.append(y)
        hw = hyper[-1].shape[2:]
        cols = [hyper[-1]] + [
            resize_to(conv2d(t, getattr(self, f"fpn{i}"), self.dtype), hw)
            for i, t in enumerate(hyper[:-1])]
        return self.segmentation_head(self.fuse(cols))
