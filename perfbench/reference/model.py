"""Plain reference of the flagship UnetPlusPlusStar (NCHW, PyTorch only).

A frozen copy of what the benchmark's windows compute, written from the
architecture: SE-ResNet50 stem and layers 1-3 (BatchNorms frozen, as the
``_Imagenet`` encoder configs have them), an axial-attention layer4 (one
downsampling block, then one shared block applied twice), the star UNet++
decoder (cross-axial gates on x_0_0, x_1_1 and x_0_1, scSE on the other
nodes), DropBlock in training and a 3×3 segmentation head. No kernel route,
no packed layout, no remat: every BatchNorm is unfolded, every attention is
the plain einsum form. The module and parameter names are those of the
program's model, so one state dict loads into both.

Precision is a :class:`Compute`: float32 with TF32 off (the reference), or
every convolution's and matmul's operands rounded to float8 e4m3 with a
per-tensor scale; with :func:`round_outputs_fp8` every module's output is
rounded so too. The control of the benchmark's comparisons (the precision
below the configuration's bfloat16) is built from these.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

F8_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in float32; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = F8_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


@dataclasses.dataclass
class Compute:
    """How the reference computes: ``fp8`` rounds the operands of every
    convolution and matmul (the control)."""

    fp8: bool = False

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x) if self.fp8 else x


class RefModule(nn.Module):
    cp = Compute()

    def __init__(self):
        super().__init__()
        self.training = False


def set_compute(model: nn.Module, cp: Compute) -> None:
    for m in model.modules():
        if isinstance(m, RefModule):
            m.cp = cp


def round_outputs_fp8(model: nn.Module) -> None:
    """Round the output of every module of ``model`` to float8 e4m3 (the
    control's storage of every intermediate)."""
    def hook(_m, _args, out):
        if isinstance(out, torch.Tensor):
            return fake_fp8(out)
        if isinstance(out, list):
            return [fake_fp8(t) for t in out]
        return out

    for m in model.modules():
        if isinstance(m, RefModule):
            m.register_forward_hook(hook)


def set_generator(model: nn.Module, generator) -> None:
    """Hand ``generator`` to every module of ``model`` that draws from one
    (a DropBlock, of this model or of another reference model)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def conv(cp: Compute, x, c: nn.Conv2d, stride=1, padding=0):
    b = c.bias
    return F.conv2d(cp.op(x), cp.op(c.weight), b, stride, padding,
                    c.dilation, c.groups)


def conv_same(cp: Compute, x, c: nn.Conv2d, stride=1):
    """flax SAME padding for an undilated square kernel (asymmetric for a
    stride-2 conv on an even map)."""
    k, pads = c.kernel_size[0], []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if len(set(pads)) == 1:
        return conv(cp, x, c, stride, pads[0])
    return conv(cp, F.pad(x, pads), c, stride)


def linear(cp: Compute, x, d: nn.Linear):
    return F.linear(cp.op(x), cp.op(d.weight), d.bias)


def matmul(cp: Compute, a, b):
    return cp.op(a) @ cp.op(b)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class BatchNorm(RefModule):
    """BatchNorm over every axis but the channel axis (1 for NCHW, the last
    for sequences). Eval or ``frozen``: running statistics. Train: batch
    mean and biased variance; the running statistics move by
    ``0.9·r + 0.1·batch`` (``unbiased_running``: the variance's n/(n−1)
    form, as the attention norms keep it)."""

    def __init__(self, channels: int, frozen: bool = False,
                 channel_axis: int = 1, unbiased_running: bool = False):
        super().__init__()
        self.frozen, self.axis = frozen, channel_axis
        self.unbiased_running = unbiased_running
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        axis = self.axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = -1
        if not self.training or self.frozen:
            mean, var = self.running_mean, self.running_var
        else:
            axes = [a for a in range(x.ndim) if a != axis]
            var, mean = torch.var_mean(x, axes, correction=0)
            n = x.numel() // x.shape[axis]
            with torch.no_grad():
                rv = var * (n / max(n - 1, 1)) if self.unbiased_running \
                    else var
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * rv)
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class DropBlock2d(RefModule):
    """timm DropBlock over 7×7 blocks (clipped to the map), centres drawn
    per sample and pixel from ``generator``, shared across channels; the
    kept values renormalised by numel / kept."""

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size
        self.generator = None

    def forward(self, x):
        if not self.training or self.drop_prob <= 0.0:
            return x
        n, _, h, w = x.shape
        bs = min(self.block_size, h, w)
        gamma = (self.drop_prob * h * w / bs ** 2
                 / max((h - bs + 1) * (w - bs + 1), 1))
        u = torch.rand((n, 1, h, w), generator=self.generator,
                       device=x.device)
        centres = (u < gamma).to(x.dtype)
        lo = (bs - 1) // 2
        c = F.pad(centres, (lo, bs - 1 - lo, lo, bs - 1 - lo))
        keep = 1.0 - F.max_pool2d(c, bs, stride=1)
        return x * keep * (keep.numel() / keep.sum().clamp(min=1.0))


class ConvBNReLU(RefModule):
    def __init__(self, cin: int, cout: int, drop_block_prob: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.drop_block = DropBlock2d(drop_block_prob)
        self.bn = BatchNorm(cout)

    def forward(self, parts: List[torch.Tensor]):
        x = torch.cat(parts, 1)
        return torch.relu(self.bn(self.drop_block(
            conv_same(self.cp, x, self.conv))))


class SEBlock(RefModule):
    def __init__(self, channels: int):
        super().__init__()
        mid = max(channels // 16, 1)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x):
        s = torch.relu(linear(self.cp, x.mean((2, 3)), self.fc1))
        s = linear(self.cp, s, self.fc2)
        return x * torch.sigmoid(s)[:, :, None, None]


class SCSEAttention(RefModule):
    """Concurrent spatial and channel squeeze-excite over the concat of
    ``parts``; returns the gated parts."""

    def __init__(self, channels: int):
        super().__init__()
        mid = max(channels // 16, 1)
        self.cse_reduce = nn.Conv2d(channels, mid, 1)
        self.cse_expand = nn.Conv2d(mid, channels, 1)
        self.sse = nn.Conv2d(channels, 1, 1)

    def forward(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        x = torch.cat(parts, 1)
        s = torch.relu(conv(self.cp, x.mean((2, 3), keepdim=True),
                            self.cse_reduce))
        gate_c = torch.sigmoid(conv(self.cp, s, self.cse_expand))
        gate_s = torch.sigmoid(conv(self.cp, x, self.sse))
        y = x * (gate_c + gate_s)
        return list(torch.split(y, [p.shape[1] for p in parts], 1))


class Bottleneck(RefModule):
    """SE bottleneck: 1×1 → 3×3 (stride) → 1×1 (×4) → SE, projection
    shortcut where the shape changes; BatchNorms frozen."""

    def __init__(self, cin: int, planes: int, strides: int):
        super().__init__()
        out = planes * 4
        self.strides = strides
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, frozen=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm(planes, frozen=True)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out, frozen=True)
        self.se = SEBlock(out)
        self.has_down = cin != out or strides != 1
        if self.has_down:
            self.down_conv = nn.Conv2d(cin, out, 1, bias=False)
            self.down_bn = BatchNorm(out, frozen=True)

    def forward(self, x):
        cp = self.cp
        y = torch.relu(self.bn1(conv(cp, x, self.conv1)))
        y = torch.relu(self.bn2(conv(cp, y, self.conv2, self.strides, 1)))
        y = self.se(self.bn3(conv(cp, y, self.conv3)))
        if self.has_down:
            x = self.down_bn(conv(cp, x, self.down_conv, self.strides))
        return torch.relu(y + x)


class SEResNet(RefModule):
    """Stem (7×7/2, BN, ReLU, 3×3/2 max-pool) and layers 1-3 of
    SE-ResNet50; returns [x, /2, /4, /8, /16]."""

    def __init__(self):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 64, 7, bias=False)
        self.stem_bn = BatchNorm(64, frozen=True)
        self.names: List[List[str]] = []
        cin = 64
        for stage, n in enumerate((3, 4, 6)):
            planes, names = 64 * 2 ** stage, []
            for i in range(n):
                name = f"layer{stage + 1}_block{i}"
                self.add_module(name, Bottleneck(
                    cin, planes, 2 if (i == 0 and stage > 0) else 1))
                cin = planes * 4
                names.append(name)
            self.names.append(names)

    def forward(self, x):
        feats = [x]
        y = torch.relu(self.stem_bn(conv(self.cp, x, self.stem_conv, 2, 3)))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for names in self.names:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats


class RelativePosEnc2D(RefModule):
    def __init__(self, dim: int, dim_v: int, dim_kq: int = 8):
        super().__init__()
        self.dim, self.dim_kq = dim, dim_kq
        self.relative = nn.Parameter(torch.zeros(2 * dim_kq + dim_v,
                                                 2 * dim - 1))
        idx = np.arange(dim)[:, None] - np.arange(dim)[None, :] + dim - 1
        self.register_buffer("index", torch.as_tensor(idx.reshape(-1)),
                             persistent=False)

    def forward(self, length: int):
        if length != self.dim:
            raise ValueError(f"sequence of {length}, table of {self.dim}")
        emb = self.relative[:, self.index].reshape(-1, self.dim, self.dim)
        kq = self.dim_kq
        return emb[:kq], emb[kq:2 * kq], emb[2 * kq:]


def attention(cp: Compute, q, k, v, r_q, r_k, r_v, logit_norm: BatchNorm,
              out_norm: BatchNorm):
    """q, k (b, L, dkq, H), v (b, L, dv, H) → (b, L, H·dv): the three logit
    maps (q·r_q, k·r_k, q·k) normalised jointly per (head, map), summed and
    softmaxed; out = attn·v and kv = attn·r_v normalised jointly and
    summed."""
    qr = torch.einsum("bdih,idj->bhdj", cp.op(q), cp.op(r_q))
    kr = torch.einsum("bdih,idj->bhdj", cp.op(k), cp.op(r_k))
    dots = torch.einsum("bdih,bjih->bhdj", cp.op(q), cp.op(k))
    stacked = torch.stack([qr, kr, dots], -1)            # (b, H, d, j, 3)
    b, h, d, j, _ = stacked.shape
    flat = logit_norm(stacked.permute(0, 2, 3, 1, 4).reshape(b, d, j, h * 3))
    logits = flat.reshape(b, d, j, h, 3).sum(-1).permute(0, 3, 1, 2)
    attn = torch.softmax(logits, -1)
    out = torch.einsum("bhdj,bjih->bhid", cp.op(attn), cp.op(v))
    kv = torch.einsum("bhdj,idj->bhid", cp.op(attn), cp.op(r_v))
    dv = out.shape[2]
    merged = torch.stack([kv, out], 1).permute(0, 4, 1, 2, 3).reshape(
        b, d, 2 * h * dv)
    return out_norm(merged).reshape(b, d, 2, h * dv).sum(2)


class AxialAttention(RefModule):
    def __init__(self, dim: int, in_channels: int, heads: int = 8,
                 dkq: int = 8):
        super().__init__()
        self.heads, self.dkq = heads, dkq
        self.dv = in_channels // heads
        n = heads * (2 * dkq + self.dv)
        self.to_qkv = nn.Parameter(torch.zeros(in_channels, n))
        self.to_qkv_bn = BatchNorm(n, channel_axis=-1, unbiased_running=True)
        self.pos_enc = RelativePosEnc2D(dim, self.dv, dkq)
        self.attention_norm = BatchNorm(heads * 3, channel_axis=-1,
                                        unbiased_running=True)
        self.out_norm = BatchNorm(2 * in_channels, channel_axis=-1,
                                  unbiased_running=True)

    def forward(self, x):
        r_q, r_k, r_v = self.pos_enc(x.shape[1])
        qkv = self.to_qkv_bn(matmul(self.cp, x, self.to_qkv))
        b, L, _ = qkv.shape
        dkq = self.dkq
        qkv = qkv.reshape(b, L, 2 * dkq + self.dv, self.heads)
        return attention(self.cp, qkv[:, :, :dkq], qkv[:, :, dkq:2 * dkq],
                         qkv[:, :, 2 * dkq:], r_q, r_k, r_v,
                         self.attention_norm, self.out_norm)


class CrossAxialAttention(RefModule):
    def __init__(self, dim: int, in_channels: int, in_skip_channels: int,
                 heads: int = 4, dkq: int = 8):
        super().__init__()
        self.heads, self.dkq = heads, dkq
        self.dv = in_skip_channels // heads
        self.to_kq = nn.Parameter(torch.zeros(in_channels, heads * 2 * dkq))
        self.to_v = nn.Parameter(torch.zeros(in_skip_channels,
                                             heads * self.dv))
        kw = dict(channel_axis=-1, unbiased_running=True)
        self.to_kq_bn = BatchNorm(heads * 2 * dkq, **kw)
        self.to_v_bn = BatchNorm(heads * self.dv, **kw)
        self.pos_enc = RelativePosEnc2D(dim, self.dv, dkq)
        self.attention_norm = BatchNorm(heads * 3, **kw)
        self.out_norm = BatchNorm(2 * in_skip_channels, **kw)

    def forward(self, x_in, skip):
        r_q, r_k, r_v = self.pos_enc(x_in.shape[1])
        kq = self.to_kq_bn(matmul(self.cp, x_in, self.to_kq))
        v = self.to_v_bn(matmul(self.cp, skip, self.to_v))
        b, L, _ = kq.shape
        kq = kq.reshape(b, L, 2 * self.dkq, self.heads)
        return attention(self.cp, kq[:, :, :self.dkq], kq[:, :, self.dkq:],
                         v.reshape(b, L, self.dv, self.heads), r_q, r_k, r_v,
                         self.attention_norm, self.out_norm)


def columns(x):
    b, c, h, w = x.shape
    return x.permute(0, 3, 2, 1).reshape(b * w, h, c)


def columns_to_rows(cols, b, h, w):
    c = cols.shape[-1]
    return cols.reshape(b, w, h, c).permute(0, 2, 1, 3).reshape(b * h, w, c)


def rows_to_nchw(rows, b, h, w):
    return rows.reshape(b, h, w, rows.shape[-1]).permute(0, 3, 1, 2)


class AxialAttentionBlock(RefModule):
    def __init__(self, cin: int, cout: int, down_sample: bool, dim: int):
        super().__init__()
        self.down_sample = down_sample
        self.in_conv = nn.Conv2d(cin, 512, 1, bias=False)
        self.in_bn = BatchNorm(512)
        self.height_att = AxialAttention(dim, 512)
        self.width_att = AxialAttention(dim, 512)
        if down_sample:
            self.shortcut_conv = nn.Conv2d(cin, cout, 3)
            self.shortcut_bn = BatchNorm(cout)
            self.att_down_bn = BatchNorm(512)
        self.out_conv = nn.Conv2d(512, cout, 1, bias=False)
        self.out_bn = BatchNorm(cout)

    def forward(self, x_in):
        cp = self.cp
        x = torch.relu(self.in_bn(conv(cp, x_in, self.in_conv)))
        b, _, h, w = x.shape
        cols = self.height_att(columns(x))
        x = rows_to_nchw(self.width_att(columns_to_rows(cols, b, h, w)),
                         b, h, w)
        shortcut = x_in
        if self.down_sample:
            shortcut = self.shortcut_bn(conv(cp, x_in, self.shortcut_conv,
                                             2, 1))
            x = self.att_down_bn(F.avg_pool2d(x, 2))
        x = self.out_bn(conv(cp, torch.relu(x), self.out_conv))
        return torch.relu(x + shortcut)


class BoTSER50Encoder(RefModule):
    out_channels = (3, 64, 256, 512, 1024, 2048)

    def __init__(self, base_dim: int):
        super().__init__()
        self.seresnet = SEResNet()
        self.layer4_first = AxialAttentionBlock(1024, 2048, True,
                                                2 * base_dim)
        self.layer4_shared = AxialAttentionBlock(2048, 2048, False, base_dim)

    def forward(self, x):
        feats = self.seresnet(x)
        y = self.layer4_shared(self.layer4_shared(
            self.layer4_first(feats[-1])))
        return feats + [y]


class DecoderBlock(RefModule):
    def __init__(self, cin: int, skip: int, cout: int, base_dim: int,
                 level: int, use_catt: bool):
        super().__init__()
        self.use_catt = use_catt
        if use_catt:
            c16 = skip // 16
            dim = base_dim * 2 ** level
            self.down_sample = nn.Conv2d(skip, c16, 1, bias=False)
            self.init_conv = nn.Conv2d(skip, c16, 1)
            self.init_bn = BatchNorm(c16)
            self.h_catt = CrossAxialAttention(dim, cin, c16)
            self.w_catt = CrossAxialAttention(dim, cin, c16)
            self.up_sample = nn.Conv2d(c16, skip, 1, bias=False)
        elif skip > 0:
            self.attention1 = SCSEAttention(cin + skip)
        self.conv1 = ConvBNReLU(cin + skip, cout)
        self.conv2 = ConvBNReLU(cout, cout)
        if not use_catt:
            self.attention2 = SCSEAttention(cout)

    def cross_gate(self, x, skip):
        cp = self.cp
        b, _, h, w = x.shape
        ori = conv(cp, skip, self.down_sample)
        s = torch.relu(self.init_bn(conv(cp, F.max_pool2d(skip, 2),
                                         self.init_conv)))
        s_cols = self.h_catt(columns(x), columns(s))
        x_rows = x.permute(0, 2, 3, 1).reshape(b * h, w, x.shape[1])
        s = rows_to_nchw(self.w_catt(x_rows,
                                     columns_to_rows(s_cols, b, h, w)),
                         b, h, w)
        return conv(cp, ori * up2(torch.sigmoid(s)), self.up_sample)

    def forward(self, x, skips: Optional[List[torch.Tensor]]):
        parts = [up2(x)]
        if skips is not None:
            if self.use_catt:
                parts.append(self.cross_gate(x, torch.cat(skips, 1)))
            else:
                parts = self.attention1(parts + skips)
        y = self.conv2([self.conv1(parts)])
        return y if self.use_catt else self.attention2([y])[0]


class UnetPlusPlusDecoder(RefModule):
    def __init__(self, enc_channels: Sequence[int],
                 decoder_channels: Sequence[int], base_dim: int):
        super().__init__()
        enc = list(enc_channels[1:])[::-1]
        cin = [enc[0]] + list(decoder_channels[:-1])
        skip = enc[1:] + [0]
        cout = list(decoder_channels)
        self.depth = depth = len(cin) - 1

        def add(d, layer):
            if d == 0:
                args = (cin[layer], skip[layer] * (layer + 1), cout[layer])
            else:
                args = (skip[layer - 1], skip[layer] * (layer + 1 - d),
                        skip[layer])
            self.add_module(f"x_{d}_{layer}", DecoderBlock(
                *args, base_dim, layer, layer in (0, 1)))

        for d in range(depth):
            add(d, d)
        for layer in range(1, depth):
            for d in range(depth - layer):
                add(d, d + layer)
        self.add_module(f"x_0_{depth}", DecoderBlock(
            cin[-1], 0, cout[-1], base_dim, 0, False))

    def forward(self, features):
        depth = self.depth
        feats = features[1:][::-1]
        dense: Dict[str, torch.Tensor] = {}
        for d in range(depth):
            dense[f"x_{d}_{d}"] = getattr(self, f"x_{d}_{d}")(
                feats[d], [feats[d + 1]])
        for layer in range(1, depth):
            for d in range(depth - layer):
                li = d + layer
                cat = ([dense[f"x_{i}_{li}"] for i in range(d + 1, li + 1)]
                       + [feats[li + 1]])
                dense[f"x_{d}_{li}"] = getattr(self, f"x_{d}_{li}")(
                    dense[f"x_{d}_{li - 1}"], cat)
        return getattr(self, f"x_0_{depth}")(dense[f"x_0_{depth - 1}"], None)


class UnetPlusPlusStar(RefModule):
    """NCHW float input → float32 logits (N, classes, H, W)."""

    def __init__(self, base_dim: int = 32,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1):
        super().__init__()
        self.encoder = BoTSER50Encoder(base_dim)
        self.decoder = UnetPlusPlusDecoder(BoTSER50Encoder.out_channels,
                                           decoder_channels, base_dim)
        self.segmentation_head = SegHead(decoder_channels[-1], classes)

    def forward(self, x):
        return self.segmentation_head(self.decoder(self.encoder(x)))


class SegHead(RefModule):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, classes, 3)

    def forward(self, x):
        return conv_same(self.cp, x, self.conv)


def build(config: dict, device=None) -> UnetPlusPlusStar:
    """The reference model of a configuration file's ``model_params``, in
    eval mode, float32, on ``device``."""
    mp = config["model_params"]
    if (config["model_name"] != "unetplusplusstar"
            or mp.get("encoder_name") != "BoTSER50_Axial_Imagenet_3"
            or mp.get("decoder_attention_type") != "scse"):
        raise ValueError("the reference holds the axial scSE "
                         "UnetPlusPlusStar only")
    with torch.device(device or "cpu"):
        return UnetPlusPlusStar(int(mp["base_dim"]),
                                tuple(mp["decoder_channels"]),
                                int(mp["classes"]))
