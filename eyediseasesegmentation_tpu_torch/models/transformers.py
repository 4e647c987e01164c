"""Transformer segmentation families (torch).

Counterpart of ``eyediseasesegmentation_tpu/models/transformers.py``:

* ``SegformerStar``: the MixVisionTransformer encoder (overlapped patch
  embedding, spatial-reduction attention, Mix-FFN; ``MIT_CONFIGS``) and the
  star decoder (``StarDecoder``: CBAM decode blocks and five per-scale heads
  merged by a softmax over five query heads);
* ``SwinformerStar``: the same decoder on the Swin backbone
  (``SwinTransformer``: windowed attention with a relative position bias,
  shifted windows, patch merging), which ``encoders.SwinPyramidEncoder``
  also serves to the Attention U-Net;
* ``TransUnet``: a ViT over the /16 map of a weight-standardised ResNetV2
  trunk (``hybrid``, TransUNet R50) or of a 16×16 patch embedding (B16),
  then a cascaded upsampler;
* ``TransUnetV2``: three single bottlenecks, a post-norm ViT at width
  1024 over the /16 tokens and an upsampler with skips.

Token maps are laid out as the JAX package lays them out: Swin's maps NHWC,
sequences (N, L, C) in row-major order; the convolutions run NCHW. Attention
is computed as JAX computes it (:func:`attend`). Parameters whose shape
depends on the input (Swin's ``rel_bias`` below a 224² input, the ViTs'
``pos_embed``) are built for ``input_size``; a forward on a side that needs
other shapes raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules.layers import (CBAM, BatchNorm, ConvBNReLU, LayerNorm,
                             PortModule, SegmentationHead, conv2d,
                             conv2d_same, gelu, linear, resize_to,
                             upsample2x, wide)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtype: torch.dtype,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(q·kᵀ / √d + bias)·v`` over (..., L, d) as the JAX package
    computes it: the scores in ``dtype``, then scaled in fp32 (its numpy
    scale promotes them), the bias added and the softmax taken in fp32, the
    probabilities cast to ``dtype`` for the product with ``v``."""
    attn = torch.matmul(q, k.transpose(-1, -2)).to(wide(dtype))
    attn = attn / math.sqrt(q.shape[-1])
    if bias is not None:
        attn = attn + bias.to(attn.dtype)
    return torch.matmul(torch.softmax(attn, -1).to(dtype), v)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, L, C) → (N, heads, L, C / heads)."""
    n, L, c = t.shape
    return t.reshape(n, L, heads, c // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(N, heads, L, d) → (N, L, heads·d)."""
    n, h, L, d = t.shape
    return t.transpose(1, 2).reshape(n, L, h * d)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → (N, H·W, C), row-major."""
    return x.flatten(2).transpose(1, 2)


def _map(seq: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H·W, C) → NCHW."""
    return seq.transpose(1, 2).reshape(seq.shape[0], -1, *hw)


def _self_attention(x: torch.Tensor, qkv: nn.Linear, heads: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Multi-head self-attention of (N, L, C) through one qkv Dense."""
    n, L, c = x.shape
    t = linear(x, qkv, dtype).reshape(n, L, 3, heads, c // heads)
    q, k, v = t.permute(2, 0, 3, 1, 4)
    return _merge_heads(attend(q, k, v, dtype))


def _size_error(who: str, what: str) -> ValueError:
    return ValueError(f"{who}: {what}: build it with the input size it runs "
                      "at (input_size)")


# ---------------------------------------------------------------------------
# MixVisionTransformer (Segformer) encoder
# ---------------------------------------------------------------------------

class OverlapPatchEmbed(PortModule):
    """``patch``² conv (stride ``stride``, flax SAME) → tokens → LayerNorm."""

    def __init__(self, cin: int, features: int, patch: int = 7,
                 stride: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        self.Conv_0 = nn.Conv2d(cin, features, patch)
        self.LayerNorm_0 = LayerNorm(features, dtype)

    def forward(self, x: torch.Tensor):
        x = conv2d_same(x, self.Conv_0, self.dtype, self.stride)
        return self.LayerNorm_0(_tokens(x)), tuple(x.shape[2:])


class SRAttention(PortModule):
    """Self-attention whose keys and values come from the map reduced by an
    ``sr_ratio``² conv (stride ``sr_ratio``) and a LayerNorm."""

    def __init__(self, features: int, heads: int, sr_ratio: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.heads, self.sr_ratio = dtype, heads, sr_ratio
        self.Dense_0 = nn.Linear(features, features)
        if sr_ratio > 1:
            self.Conv_0 = nn.Conv2d(features, features, sr_ratio)
            self.LayerNorm_0 = LayerNorm(features, dtype)
        self.Dense_1 = nn.Linear(features, features)
        self.Dense_2 = nn.Linear(features, features)
        self.Dense_3 = nn.Linear(features, features)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        dt = self.dtype
        q = linear(x, self.Dense_0, dt)
        kv = x
        if self.sr_ratio > 1:
            kv = conv2d_same(_map(x, hw), self.Conv_0, dt, self.sr_ratio)
            kv = self.LayerNorm_0(_tokens(kv))
        k, v = linear(kv, self.Dense_1, dt), linear(kv, self.Dense_2, dt)
        out = attend(*(_heads(t, self.heads) for t in (q, k, v)), dt)
        return linear(_merge_heads(out), self.Dense_3, dt)


class MixFFN(PortModule):
    """Dense → depthwise 3×3 → tanh-GELU → Dense (Mix-FFN)."""

    def __init__(self, features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(features, hidden)
        self.Conv_0 = nn.Conv2d(hidden, hidden, 3, groups=hidden)
        self.Dense_1 = nn.Linear(hidden, features)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        y = _map(linear(x, self.Dense_0, self.dtype), hw)
        y = gelu(_tokens(conv2d_same(y, self.Conv_0, self.dtype)))
        return linear(y, self.Dense_1, self.dtype)


class MixViTBlock(PortModule):
    def __init__(self, features: int, heads: int, sr_ratio: int,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(features, dtype)
        self.SRAttention_0 = SRAttention(features, heads, sr_ratio, dtype)
        self.LayerNorm_1 = LayerNorm(features, dtype)
        self.MixFFN_0 = MixFFN(features, features * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = x + self.SRAttention_0(self.LayerNorm_0(x), hw)
        return x + self.MixFFN_0(self.LayerNorm_1(x), hw)


MIT_CONFIGS = {
    "mit_b0": dict(dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": dict(dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "mit_b2": dict(dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
}
MIT_HEADS = (1, 2, 5, 8)
MIT_SR = (8, 4, 2, 1)


class MixVisionTransformer(PortModule):
    """NCHW input → the NCHW pyramid [/4, /8, /16, /32]."""

    def __init__(self, variant: str = "mit_b0",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = MIT_CONFIGS[variant]
        self.dims, self.depths = cfg["dims"], cfg["depths"]
        cin = 3
        for stage, (dim, depth) in enumerate(zip(self.dims, self.depths)):
            patch, stride = (7, 4) if stage == 0 else (3, 2)
            self.add_module(f"embed{stage}", OverlapPatchEmbed(
                cin, dim, patch, stride, dtype))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", MixViTBlock(
                    dim, MIT_HEADS[stage], MIT_SR[stage], dtype=dtype))
            self.add_module(f"norm{stage}", LayerNorm(dim, dtype))
            cin = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for stage, depth in enumerate(self.depths):
            seq, hw = getattr(self, f"embed{stage}")(x)
            for i in range(depth):
                seq = getattr(self, f"stage{stage}_block{i}")(seq, hw)
            x = _map(getattr(self, f"norm{stage}")(seq), hw)
            feats.append(x)
        return feats


# ---------------------------------------------------------------------------
# Swin backbone
# ---------------------------------------------------------------------------

def _rel_index(ws: int) -> np.ndarray:
    """(ws², ws²) indices into the (2·ws − 1)² bias table:
    ``rel[0]·(2ws − 1) + rel[1]`` over ij-meshgrid coordinates."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    return rel[0] * (2 * ws - 1) + rel[1]


class WindowAttention(PortModule):
    """Self-attention within windows of ``window``² tokens, with the
    relative position bias ``rel_bias`` ((2·window − 1)², heads) and an
    optional additive mask (nWin, L, L)."""

    def __init__(self, features: int, heads: int, window: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.heads = dtype, heads
        self.Dense_0 = nn.Linear(features, 3 * features)
        self.Dense_1 = nn.Linear(features, features)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                 heads))
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_index(window).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nW, L, c = x.shape
        bias = self.rel_bias[self.rel_index].reshape(L, L, self.heads)
        bias = bias.permute(2, 0, 1)                 # (heads, L, L)
        t = linear(x, self.Dense_0, self.dtype)
        qkv = t.reshape(nW, L, 3, self.heads, c // self.heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)             # (3, nW, heads, L, d)
        if mask is not None:
            # (images, windows of a map, heads, L, L): the mask of each
            # window broadcast over the images
            n_win = mask.shape[0]
            qkv = qkv.reshape(3, nW // n_win, n_win, *qkv.shape[2:])
            bias = bias + mask[:, None]
        q, k, v = qkv
        out = attend(q, k, v, self.dtype, bias).reshape(nW, self.heads, L, -1)
        return linear(_merge_heads(out), self.Dense_1, self.dtype)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """NHWC → (N·windows, ws², C), windows row-major per image."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int,
                    w: int) -> torch.Tensor:
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _shift_mask(hp: int, wp: int, ws: int, shift: int,
                device) -> torch.Tensor:
    """(windows, ws², ws²) mask of the shifted windows on the PADDED
    canvas: −100 between tokens of different rolled-over regions."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _window_partition(img, ws)[..., 0]
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


def swin_window(window: int, h: int, w: int) -> Tuple[int, int]:
    """(window, shift bound) on an h×w map: the window shrinks to the map,
    and a map no larger than the window is not shifted (0)."""
    ws = min(window, h, w)
    return ws, (ws - 1 if min(h, w) > ws else 0)


class SwinBlock(PortModule):
    """Swin block over an NHWC map built for a ``side``² map: LayerNorm,
    zero padding to window multiples AFTER the norm (the pad tokens join
    their edge windows; unmasked when not shifted), a roll by −shift with
    the mask of the padded canvas, window attention, the roll back, the
    crop, the residual; then LayerNorm → Dense → tanh-GELU → Dense."""

    def __init__(self, features: int, heads: int, window: int = 7,
                 shift: int = 0, mlp_ratio: int = 4, side: int = 56,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.window, self.shift = dtype, window, shift
        self.ws = swin_window(window, side, side)[0]
        self.LayerNorm_0 = LayerNorm(features, dtype)
        self.WindowAttention_0 = WindowAttention(features, heads, self.ws,
                                                 dtype)
        self.LayerNorm_1 = LayerNorm(features, dtype)
        self.Dense_0 = nn.Linear(features, features * mlp_ratio)
        self.Dense_1 = nn.Linear(features * mlp_ratio, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        ws, max_shift = swin_window(self.window, h, w)
        if ws != self.ws:
            raise _size_error("SwinBlock", f"its bias table is for a "
                              f"{self.ws}² window and a {h}x{w} map takes "
                              f"{ws}²")
        shift = min(self.shift, max_shift)
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp = h + pad_h, w + pad_w
        y = self.LayerNorm_0(x)
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = _shift_mask(hp, wp, ws, shift, x.device)
        y = self.WindowAttention_0(_window_partition(y, ws), mask)
        y = _window_reverse(y, ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y[:, :h, :w]
        y = gelu(linear(self.LayerNorm_1(x), self.Dense_0, self.dtype))
        return x + linear(y, self.Dense_1, self.dtype)


SWIN_CONFIGS = {
    "swin_tiny": dict(dims=(96, 192, 384, 768), depths=(2, 2, 6, 2),
                      heads=(3, 6, 12, 24)),
    "swin_small": dict(dims=(96, 192, 384, 768), depths=(2, 2, 18, 2),
                       heads=(3, 6, 12, 24)),
}


class SwinTransformer(PortModule):
    """NCHW input → the NCHW pyramid [/4, /8, /16, /32]: a 4×4 / 4 patch
    embedding (flax SAME) and LayerNorm, then four stages of Swin blocks
    (odd blocks shifted by ``window // 2``), stages 1-3 opened by patch
    merging: the 2×2 neighbours' channels in (dh, dw, c) order, LayerNorm,
    a Dense without bias. The blocks are built for an ``input_size``²
    input (their windows shrink on maps under 7²)."""

    def __init__(self, variant: str = "swin_tiny", window: int = 7,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = SWIN_CONFIGS[variant]
        self.dtype, self.depths = dtype, cfg["depths"]
        dims = cfg["dims"]
        self.patch_embed = nn.Conv2d(3, dims[0], 4)
        self.LayerNorm_0 = LayerNorm(dims[0], dtype)
        side = -(-input_size // 4)
        for stage, (dim, depth, heads) in enumerate(zip(dims, self.depths,
                                                        cfg["heads"])):
            if stage > 0:
                side //= 2
                self.add_module(f"LayerNorm_{stage}",
                                LayerNorm(4 * dims[stage - 1], dtype))
                self.add_module(f"Dense_{stage - 1}", nn.Linear(
                    4 * dims[stage - 1], dim, bias=False))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", SwinBlock(
                    dim, heads, window, 0 if i % 2 == 0 else window // 2,
                    side=side, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = conv2d_same(x, self.patch_embed, self.dtype, 4)
        x = self.LayerNorm_0(x.permute(0, 2, 3, 1))
        feats = []
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                n, h, w, c = x.shape
                x = x.reshape(n, h // 2, 2, w // 2, 2, c)
                x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2,
                                                        4 * c)
                x = getattr(self, f"LayerNorm_{stage}")(x)
                x = linear(x, getattr(self, f"Dense_{stage - 1}"),
                           self.dtype)
            for i in range(depth):
                x = getattr(self, f"stage{stage}_block{i}")(x)
            feats.append(x.permute(0, 3, 1, 2))
        return feats


# ---------------------------------------------------------------------------
# Star decoder shared by both *Star models
# ---------------------------------------------------------------------------

class StarDecoder(PortModule):
    """Six decode blocks (conv-BN-ReLU → CBAM → bilinear ×2, the centre
    one not enlarged) up the pyramid, each of the five finest maps enlarged
    to the input size and given a 1×1 prediction head ``deep{i}`` and a
    1×1 query head ``que{i}``: the output is the predictions weighted by a
    softmax over the five queries, in fp32. ``deep_supervision`` adds the
    predictions [s4..s1], ``clf_head`` a classifier on the /32 map (mean →
    LayerNorm → Dense 256 → ELU → LayerNorm → Dense)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: int = 64, classes: int = 1,
                 deep_supervision: bool = False, clf_head: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision, self.clf_head = deep_supervision, clf_head
        c1, c2, c3, c4 = encoder_channels
        dc = decoder_channels
        if clf_head:
            self.LayerNorm_0 = LayerNorm(c4, dtype)
            self.Dense_0 = nn.Linear(c4, 256)
            self.LayerNorm_1 = LayerNorm(256, dtype)
            self.Dense_1 = nn.Linear(256, classes)
        for name, cin in (("center", c4), ("dec4", c4 + dc),
                          ("dec3", c3 + dc), ("dec2", c2 + dc),
                          ("dec1", c1 + dc), ("dec0", dc)):
            self.add_module(f"{name}_conv", ConvBNReLU(cin, dc, dtype, 0.0))
            self.add_module(f"{name}_cbam", CBAM(dc, dtype=dtype))
        for i in range(5):
            self.add_module(f"deep{i}", nn.Conv2d(dc, classes, 1))
            self.add_module(f"que{i}", nn.Conv2d(dc, classes, 1))

    def _decode(self, name: str, x, up: bool = True) -> torch.Tensor:
        y = getattr(self, f"{name}_cbam")(getattr(self, f"{name}_conv")(x))
        return upsample2x(y) if up else y

    def forward(self, feats: List[torch.Tensor], out_hw):
        x1, x2, x3, x4 = feats
        dt, wd = self.dtype, wide(self.dtype)
        clf = None
        if self.clf_head:
            s = self.LayerNorm_0(x4.mean((2, 3)))
            s = F.elu(linear(s, self.Dense_0, dt))
            clf = linear(self.LayerNorm_1(s), self.Dense_1, dt).to(wd)
        y5 = self._decode("center", x4, up=False)
        y4 = self._decode("dec4", [x4, y5])          # /16
        y3 = self._decode("dec3", [x3, y4])          # /8
        y2 = self._decode("dec2", [x2, y3])          # /4
        y1 = self._decode("dec1", [x1, y2])          # /2
        y0 = self._decode("dec0", y1)                # /1
        preds, queries = [], []
        for i, y in enumerate((y0, y1, y2, y3, y4)):
            u = resize_to(y, out_hw)
            preds.append(conv2d(u, getattr(self, f"deep{i}"), dt))
            queries.append(conv2d(u, getattr(self, f"que{i}"), dt))
        p = torch.stack(preds, 1).to(wd)             # (B, 5, C, H, W)
        attn = torch.softmax(torch.stack(queries, 1).to(wd), 1)
        combined = (attn * p).sum(1)
        if self.deep_supervision:
            deeps = [preds[i].to(wd) for i in (4, 3, 2, 1)]   # [s4..s1]
            return (combined, deeps, clf) if self.clf_head else \
                (combined, deeps)
        return (combined, clf) if self.clf_head else combined


class SegformerStar(PortModule):
    """MixViT encoder + star decoder."""

    def __init__(self, encoder_name: str = "mit_b0", classes: int = 1,
                 deep_supervision: bool = False, clf_head: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = MixVisionTransformer(encoder_name, dtype)
        self.decoder = StarDecoder(self.encoder.dims, classes=classes,
                                   deep_supervision=deep_supervision,
                                   clf_head=clf_head, dtype=dtype)

    def forward(self, x: torch.Tensor):
        return self.decoder(self.encoder(x), x.shape[2:])


class SwinformerStar(PortModule):
    """Swin backbone (built for an ``input_size``² input) + star decoder."""

    def __init__(self, encoder_name: str = "swin_tiny", classes: int = 1,
                 deep_supervision: bool = False, clf_head: bool = False,
                 input_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = SwinTransformer(encoder_name, input_size=input_size,
                                       dtype=dtype)
        self.decoder = StarDecoder(SWIN_CONFIGS[encoder_name]["dims"],
                                   classes=classes,
                                   deep_supervision=deep_supervision,
                                   clf_head=clf_head, dtype=dtype)

    def forward(self, x: torch.Tensor):
        return self.decoder(self.encoder(x), x.shape[2:])


# ---------------------------------------------------------------------------
# TransUNet
# ---------------------------------------------------------------------------

class ViTBlock(PortModule):
    """Pre-norm ViT block: LayerNorm → MHSA → residual, LayerNorm → Dense →
    tanh-GELU → Dense → residual."""

    def __init__(self, features: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.heads = dtype, heads
        self.LayerNorm_0 = LayerNorm(features, dtype)
        self.Dense_0 = nn.Linear(features, 3 * features)
        self.Dense_1 = nn.Linear(features, features)
        self.LayerNorm_1 = LayerNorm(features, dtype)
        self.Dense_2 = nn.Linear(features, features * mlp_ratio)
        self.Dense_3 = nn.Linear(features * mlp_ratio, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        o = _self_attention(self.LayerNorm_0(x), self.Dense_0, self.heads,
                            dt)
        x = x + linear(o, self.Dense_1, dt)
        y = gelu(linear(self.LayerNorm_1(x), self.Dense_2, dt))
        return x + linear(y, self.Dense_3, dt)


def std_conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
               stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``conv`` with its kernel standardised per output channel over (Cin,
    kh, kw), with the biased variance and epsilon 1e-5, in fp32, then cast
    to ``dtype`` (weight standardisation, no bias)."""
    w = conv.weight
    m = w.mean((1, 2, 3), keepdim=True)
    v = w.var((1, 2, 3), keepdim=True, correction=0)
    ws = (w - m) * torch.rsqrt(v + 1e-5)
    return F.conv2d(x.to(dtype), ws.to(dtype), None, stride, padding)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm``: epsilon 1e-6, statistics and affine in fp32
    (or wider), the output in ``dtype``."""

    def __init__(self, groups: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(groups, channels, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = wide(x.dtype)
        return F.group_norm(x.to(w), self.num_groups, self.weight.to(w),
                            self.bias.to(w), self.eps).to(self.dtype)


class PreActBottleneck(PortModule):
    """ResNetV2 bottleneck: weight-standardised 1×1 → 3×3 (stride, pad 1)
    → 1×1, each followed by a GroupNorm (32 groups; ReLU after the first
    two), and a standardised 1×1 projection with a per-channel GroupNorm
    where the shape changes."""

    def __init__(self, cin: int, cout: int, cmid: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.strides = dtype, strides
        self.has_down = strides != 1 or cin != cout
        if self.has_down:
            self.downsample = nn.Conv2d(cin, cout, 1, bias=False)
            self.gn_proj = GroupNorm(cout, cout, dtype)
        self.conv1 = nn.Conv2d(cin, cmid, 1, bias=False)
        self.gn1 = GroupNorm(32, cmid, dtype)
        self.conv2 = nn.Conv2d(cmid, cmid, 3, bias=False)
        self.gn2 = GroupNorm(32, cmid, dtype)
        self.conv3 = nn.Conv2d(cmid, cout, 1, bias=False)
        self.gn3 = GroupNorm(32, cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        residual = x
        if self.has_down:
            residual = self.gn_proj(std_conv2d(x, self.downsample, dt,
                                               self.strides))
        y = torch.relu(self.gn1(std_conv2d(x, self.conv1, dt)))
        y = torch.relu(self.gn2(std_conv2d(y, self.conv2, dt, self.strides,
                                           1)))
        y = self.gn3(std_conv2d(y, self.conv3, dt))
        return torch.relu(residual + y)


class ResNetV2Trunk(PortModule):
    """The TransUNet-R50 trunk: a standardised 7×7 / 2 root (pad 3),
    GroupNorm and ReLU (the /2 skip), an unpadded 3×3 / 2 max-pool, then
    three stages of pre-activation bottlenecks. The pool leaves the map one
    pixel short (15 for a 64² input): each of the first two stages' output
    is zero-padded bottom and right to ``H // (4·(stage + 1))`` as its skip,
    while the trunk goes on at the odd size. Returns (the final /16 map,
    [skip /8, skip /4, skip /2])."""

    def __init__(self, block_units: Sequence[int] = (3, 4, 9),
                 width_factor: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        width = int(64 * width_factor)
        self.root_conv = nn.Conv2d(3, width, 7, bias=False)
        self.root_gn = GroupNorm(32, width, dtype)
        self.out_channels = (width * 8, width * 4, width)   # the skips
        self.names: List[List[str]] = []
        cin = width
        stages = [(width * 4, width, 1), (width * 8, width * 2, 2),
                  (width * 16, width * 4, 2)]
        for si, (cout, cmid, stride) in enumerate(stages):
            names = []
            for u in range(block_units[si]):
                name = f"block{si + 1}_unit{u + 1}"
                self.add_module(name, PreActBottleneck(
                    cin, cout, cmid, stride if u == 0 else 1, dtype))
                names.append(name)
                cin = cout
            self.names.append(names)

    def forward(self, x: torch.Tensor):
        in_size = x.shape[2]
        y = std_conv2d(x, self.root_conv, self.dtype, 2, 3)
        y = torch.relu(self.root_gn(y))
        feats = [y]
        y = F.max_pool2d(y, 3, stride=2)
        for si, names in enumerate(self.names):
            for name in names:
                y = getattr(self, name)(y)
            if si < 2:
                pad = in_size // (4 * (si + 1)) - y.shape[2]
                if not 0 <= pad < 3:
                    raise ValueError(f"ResNetV2Trunk: stage {si + 1} map "
                                     f"{tuple(y.shape[2:])} for an input of "
                                     f"{in_size}")
                feats.append(F.pad(y, (0, pad, 0, pad)) if pad else y)
        return y, feats[::-1]


def _trunk_side(n: int) -> int:
    """The side of ResNetV2Trunk's /16 map on an n² input."""
    n = (n - 1) // 2 + 1                # root 7×7 / 2, pad 3
    n = (n - 3) // 2 + 1                # VALID 3×3 / 2 max-pool
    for _ in range(2):                  # stride-2 3×3, pad 1
        n = (n - 1) // 2 + 1
    return n


class TransUnet(PortModule):
    """ViT bottleneck + cascaded upsampler. ``hybrid`` (TransUnet_R50): the
    ViT runs on the ResNetV2 trunk's /16 map after a 1×1 projection, and
    the trunk's /8, /4, /2 maps are the skips; otherwise (TransUnet_B16) on
    a 16×16 / 16 patch embedding, without skips. ``pos_embed`` holds one
    row per /16 token of an ``input_size``² input."""

    def __init__(self, hidden: int = 256, depth: int = 4, heads: int = 8,
                 hybrid: bool = True,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16),
                 classes: int = 1, input_size: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.hybrid, self.depth = dtype, hybrid, depth
        skips: Sequence[int] = ()
        if hybrid:
            self.trunk = ResNetV2Trunk(dtype=dtype)
            self.patch_proj = nn.Conv2d(1024, hidden, 1)
            skips, side = self.trunk.out_channels, _trunk_side(input_size)
        else:
            self.patch_embed = nn.Conv2d(3, hidden, 16)
            side = -(-input_size // 16)
        self.pos_embed = nn.Parameter(torch.zeros(1, side * side, hidden))
        for i in range(depth):
            self.add_module(f"vit{i}", ViTBlock(hidden, heads, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.n_dec, cin = len(decoder_channels), hidden
        for i, ch in enumerate(decoder_channels):
            cat = cin + (skips[i] if i < len(skips) else 0)
            self.add_module(f"dec{i}", ConvBNReLU(cat, ch, dtype, 0.0))
            cin = ch
        self.segmentation_head = SegmentationHead(cin, classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2:]
        skips: List[torch.Tensor] = []
        if self.hybrid:
            y, skips = self.trunk(x)
            y = conv2d(y, self.patch_proj, self.dtype)
        else:
            y = conv2d_same(x, self.patch_embed, self.dtype, 16)
        hw = tuple(y.shape[2:])
        seq = _tokens(y)
        if seq.shape[1] != self.pos_embed.shape[1]:
            raise _size_error("TransUnet", f"pos_embed has "
                              f"{self.pos_embed.shape[1]} rows and a "
                              f"{H}x{W} input gives {seq.shape[1]} tokens")
        seq = seq + self.pos_embed.to(seq.dtype)
        for i in range(self.depth):
            seq = getattr(self, f"vit{i}")(seq)
        y = _map(self.LayerNorm_0(seq), hw)
        for i in range(self.n_dec):
            y = upsample2x(y)
            if i < len(skips):
                y = [y, skips[i]]
            y = getattr(self, f"dec{i}")(y)
        if y.shape[2] != H:
            y = resize_to(y, (H, W))
        return self.segmentation_head(y)


# ---------------------------------------------------------------------------
# TransUnetV2 (the self_attention_cv variant)
# ---------------------------------------------------------------------------

class _SacvBottleneck(PortModule):
    """1×1 → BN/ReLU → 3×3 (stride, flax SAME) → BN/ReLU → 1×1 → BN, plus
    a 1×1 (stride) + BN projection, then ReLU; inner width out_ch / 4."""

    def __init__(self, cin: int, out_ch: int, stride: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        width = out_ch // 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width, dtype)
        self.conv2 = nn.Conv2d(width, width, 3, bias=False)
        self.bn2 = BatchNorm(width, dtype)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch, dtype)
        self.downsample = nn.Conv2d(cin, out_ch, 1, bias=False)
        self.bn_down = BatchNorm(out_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, s = self.dtype, self.stride
        y = torch.relu(self.bn1(conv2d(x, self.conv1, dt)))
        y = torch.relu(self.bn2(conv2d_same(y, self.conv2, dt, s)))
        y = self.bn3(conv2d(y, self.conv3, dt))
        sc = self.bn_down(conv2d_same(x, self.downsample, dt, s))
        return torch.relu(y + sc)


class _SacvPostNormBlock(PortModule):
    """Post-norm block: x = LN(MHSA(x) + x) (qkv without bias), x =
    LN(MLP(x) + x) with a tanh-GELU MLP."""

    def __init__(self, features: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.heads = dtype, heads
        self.qkv = nn.Linear(features, 3 * features, bias=False)
        self.proj = nn.Linear(features, features)
        self.norm1 = LayerNorm(features, dtype)
        self.mlp1 = nn.Linear(features, mlp_dim)
        self.mlp2 = nn.Linear(mlp_dim, features)
        self.norm2 = LayerNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        o = _self_attention(x, self.qkv, self.heads, dt)
        x = self.norm1(x + linear(o, self.proj, dt))
        y = linear(gelu(linear(x, self.mlp1, dt)), self.mlp2, dt)
        return self.norm2(x + y)


class TransUnetV2(PortModule):
    """7×7 / 2 stem to ``inplanes``, three single bottlenecks (channels ×2,
    /2 each) to ``inplanes``·8 at /16, a post-norm ViT (``vit_blocks``
    blocks, ``vit_heads`` heads, MLP ``vit_mlp``) over the /16 tokens with
    a Dense projection and ``pos_embed`` (one row per token of an
    ``input_size``² input), a 3×3 conv to 512, then four steps of bilinear
    ×2, the skip concatenated FIRST, and one 3×3 conv-BN-ReLU (256, 128,
    64, 16), and a 1×1 head in fp32."""

    def __init__(self, classes: int = 1, vit_blocks: int = 12,
                 vit_heads: int = 4, vit_mlp: int = 1024,
                 inplanes: int = 128, input_size: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.vit_blocks = dtype, vit_blocks
        vit_ch = inplanes * 8
        self.init_conv = nn.Conv2d(3, inplanes, 7, bias=False)
        self.init_bn = BatchNorm(inplanes, dtype)
        self.conv1 = _SacvBottleneck(inplanes, inplanes * 2, dtype=dtype)
        self.conv2 = _SacvBottleneck(inplanes * 2, inplanes * 4, dtype=dtype)
        self.conv3 = _SacvBottleneck(inplanes * 4, vit_ch, dtype=dtype)
        self.project_patches = nn.Linear(vit_ch, vit_ch)
        side = -(-input_size // 16)
        self.pos_embed = nn.Parameter(torch.zeros(1, side * side, vit_ch))
        for i in range(vit_blocks):
            self.add_module(f"vit{i}", _SacvPostNormBlock(
                vit_ch, vit_heads, vit_mlp, dtype))
        self._single_conv("vit_conv", vit_ch, 512)
        cin = 512
        for i, (skip, out_ch) in enumerate(
                [(inplanes * 4, 256), (inplanes * 2, 128), (inplanes, 64),
                 (0, 16)]):
            self._single_conv(f"dec{i + 1}", skip + cin, out_ch)
            cin = out_ch
        self.head = nn.Conv2d(cin, classes, 1)

    def _single_conv(self, name: str, cin: int, cout: int):
        self.add_module(f"{name}_conv", nn.Conv2d(cin, cout, 3, bias=False))
        self.add_module(f"{name}_bn", BatchNorm(cout, self.dtype))

    def single_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, getattr(self, f"{name}_conv"), self.dtype, padding=1)
        return torch.relu(getattr(self, f"{name}_bn")(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv2d_same(x, self.init_conv, dt, 2)
        x2 = torch.relu(self.init_bn(y))
        x4 = self.conv1(x2)
        x8 = self.conv2(x4)
        x16 = self.conv3(x8)
        hw = tuple(x16.shape[2:])
        seq = linear(_tokens(x16), self.project_patches, dt)
        if seq.shape[1] != self.pos_embed.shape[1]:
            raise _size_error("TransUnetV2", f"pos_embed has "
                              f"{self.pos_embed.shape[1]} rows and a "
                              f"{x.shape[2]}x{x.shape[3]} input gives "
                              f"{seq.shape[1]} tokens")
        seq = seq + self.pos_embed.to(seq.dtype)
        for i in range(self.vit_blocks):
            seq = getattr(self, f"vit{i}")(seq)
        y = self.single_conv("vit_conv", _map(seq, hw))
        for i, skip in enumerate((x8, x4, x2, None)):
            y = resize_to(y, (2 * y.shape[2], 2 * y.shape[3]))
            if skip is not None:
                y = torch.cat([skip.to(y.dtype), y], 1)
            y = self.single_conv(f"dec{i + 1}", y)
        return conv2d(y, self.head, dt).to(wide(dt))
