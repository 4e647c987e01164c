"""Axial and cross-axial attention (torch, NCHW blocks).

Counterpart of ``eyediseasesegmentation_tpu/models/modules/axial.py``.
Sequences are (batch, length, channels), as in the JAX package. In eval the
three BatchNorms of an attention fold into affines and the whole attention
is one call of ``ops.axial_attention`` (the CUDA kernel on a GPU tensor). In
training the attention runs as plain differentiable ops (the kernel has no
backward): the norms use fp32 batch statistics, normalise with the biased
variance and move their running variance by the **unbiased** one, n/(n−1),
as the JAX package's inline ``_Norm`` does (n the whole batch's count under
``parallel.mesh.data_parallel``).

Parameters keep the layout that op takes: ``to_qkv`` / ``to_kq`` / ``to_v``
are (in, out) matrices whose output channel is q_idx·H + h, and
``pos_enc.relative`` is the (2·dkq + dv, 2·dim − 1) table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import axial_attention as AK
from .layers import (BatchNorm, PortModule, batch_count, batch_moments,
                     conv2d, recomputing, wide)


class RelativePosEnc2D(PortModule):
    """Learned relative position embeddings: (r_q, r_k, r_v) of shapes
    (dkq, dim, dim), (dkq, dim, dim), (dv, dim, dim) gathered from one table
    with index i − j + dim − 1. The table fixes the sequence length: any
    other raises ``ValueError``, as the JAX package's einsum does."""

    def __init__(self, dim: int, dim_v: int = 16, dim_kq: int = 8):
        super().__init__()
        self.dim, self.dim_kq = dim, dim_kq
        self.relative = nn.Parameter(
            torch.zeros(2 * dim_kq + dim_v, 2 * dim - 1))
        idx = (np.arange(dim)[:, None] - np.arange(dim)[None, :] + dim - 1)
        self.register_buffer("index", torch.as_tensor(idx.reshape(-1)),
                             persistent=False)

    def forward(self, length: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if length != self.dim:
            raise ValueError(
                f"axial attention of length {length}: the relative-position "
                f"table is built for {self.dim} (the model takes one input "
                "size)")
        emb = self.relative[:, self.index].reshape(-1, self.dim, self.dim)
        kq = self.dim_kq
        return emb[:kq], emb[kq:2 * kq], emb[2 * kq:]


def norm_train(norm: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """An attention's inline norm in training: fp32 statistics over every
    axis but the last, normalised with the biased variance; the running
    variance moves by the unbiased one (momentum 0.9 in flax's sense),
    except while a ``remat`` block is recomputed. Returns the input's
    dtype."""
    axes = tuple(range(x.ndim - 1))
    xf, mean, var = batch_moments(x, axes)
    n = batch_count(x, axes)       # the whole batch's under data_parallel
    if not recomputing():
        with torch.no_grad():
            m = norm.momentum
            norm.running_mean.copy_(m * norm.running_mean + (1 - m) * mean)
            norm.running_var.copy_(m * norm.running_var
                                   + (1 - m) * var * (n / max(n - 1, 1)))
    y = (xf - mean) * torch.rsqrt(var + 1e-5) * norm.weight + norm.bias
    return y.to(x.dtype)


def attention_core_train(q, k, v, r_q, r_k, r_v, logit_norm: BatchNorm,
                         dtype):
    """The attention products in training. q, k: (b, L, dkq, H); v:
    (b, L, dv, H); r_*: (d, L, L). The three logit maps are stacked and
    normalised jointly over channel order (h, n), summed, and softmaxed in
    fp32 (or wider). Returns (out, kv), each (b, H, dv, L)."""
    qr = torch.einsum("bdih,idj->bhdj", q, r_q.to(dtype))
    kr = torch.einsum("bdih,idj->bhdj", k, r_k.to(dtype))
    dots = torch.einsum("bdih,bjih->bhdj", q, k)
    stacked = torch.stack([qr, kr, dots], -1)           # (b, H, d, j, 3)
    b, h, d, j, _ = stacked.shape
    flat = stacked.permute(0, 2, 3, 1, 4).reshape(b, d, j, h * 3)
    flat = norm_train(logit_norm, flat)
    logits = flat.reshape(b, d, j, h, 3).sum(-1).permute(0, 3, 1, 2)
    attn = torch.softmax(logits.to(wide(logits.dtype)), -1).to(dtype)
    out = torch.einsum("bhdj,bjih->bhid", attn, v)
    kv = torch.einsum("bhdj,idj->bhid", attn, r_v.to(dtype))
    return out, kv


def merge_outputs_train(out, kv, out_norm: BatchNorm):
    """The joint norm of the stacked (kv, out), channel order (n, h, i),
    then their sum: (b, H, dv, L) each → (b, L, H·dv)."""
    b, h, dv, L = out.shape
    stacked = torch.stack([kv, out], 1)                  # (b, 2, H, dv, L)
    flat = stacked.permute(0, 4, 1, 2, 3).reshape(b, L, 2 * h * dv)
    flat = norm_train(out_norm, flat)
    return flat.reshape(b, L, 2, h * dv).sum(2)


class AxialAttention(PortModule):
    """Single-axis self-attention with relative position terms.
    Input/output (b, L, C) with L == ``dim`` and C == ``in_channels``."""

    def __init__(self, dim: int, in_channels: int = 128, heads: int = 8,
                 dim_head_kq: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dkq, self.dtype = heads, dim_head_kq, dtype
        self.dv = in_channels // heads
        qkv_ch = 2 * dim_head_kq + self.dv
        self.to_qkv = nn.Parameter(torch.zeros(in_channels, heads * qkv_ch))
        self.to_qkv_bn = BatchNorm(heads * qkv_ch)
        self.pos_enc = RelativePosEnc2D(dim, self.dv, dim_head_kq)
        self.attention_norm = BatchNorm(heads * 3)
        self.out_norm = BatchNorm(2 * in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r_q, r_k, r_v = self.pos_enc(x.shape[1])
        if self.training:
            dt, dkq = self.dtype, self.dkq
            qkv = norm_train(self.to_qkv_bn, x.to(dt) @ self.to_qkv.to(dt))
            b, L, _ = qkv.shape
            # channel = q_idx·H + h
            qkv = qkv.reshape(b, L, 2 * dkq + self.dv, self.heads)
            out, kv = attention_core_train(
                qkv[:, :, :dkq], qkv[:, :, dkq:2 * dkq], qkv[:, :, 2 * dkq:],
                r_q, r_k, r_v, self.attention_norm, dt)
            return merge_outputs_train(out, kv, self.out_norm)
        return AK.axial_attention(
            x, x, self.to_qkv, None, self.to_qkv_bn.folded(), None,
            r_q, r_k, r_v, self.attention_norm.folded(),
            self.out_norm.folded(), heads=self.heads, dkq=self.dkq,
            dv=self.dv, dtype=self.dtype)


class CrossAxialAttention(PortModule):
    """Axial attention with q, k from the decoder state and v from the skip
    (the UNet++ skip gate). x_in (b, L, C_in), skip (b, L, C_skip) →
    (b, L, C_skip)."""

    def __init__(self, dim: int, in_channels: int = 128,
                 in_skip_channels: int = 128, heads: int = 8,
                 dim_head_kq: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dkq, self.dtype = heads, dim_head_kq, dtype
        self.dv = in_skip_channels // heads
        self.to_kq = nn.Parameter(torch.zeros(in_channels,
                                              heads * 2 * dim_head_kq))
        self.to_v = nn.Parameter(torch.zeros(in_skip_channels,
                                             heads * self.dv))
        self.to_kq_bn = BatchNorm(heads * 2 * dim_head_kq)
        self.to_v_bn = BatchNorm(heads * self.dv)
        self.pos_enc = RelativePosEnc2D(dim, self.dv, dim_head_kq)
        self.attention_norm = BatchNorm(heads * 3)
        self.out_norm = BatchNorm(2 * in_skip_channels)

    def forward(self, x_in: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        r_q, r_k, r_v = self.pos_enc(x_in.shape[1])
        if self.training:
            dt, dkq = self.dtype, self.dkq
            kq = norm_train(self.to_kq_bn, x_in.to(dt) @ self.to_kq.to(dt))
            v = norm_train(self.to_v_bn, skip.to(dt) @ self.to_v.to(dt))
            b, L, _ = kq.shape
            kq = kq.reshape(b, L, 2 * dkq, self.heads)
            out, kv = attention_core_train(
                kq[:, :, :dkq], kq[:, :, dkq:],
                v.reshape(b, L, self.dv, self.heads), r_q, r_k, r_v,
                self.attention_norm, dt)
            return merge_outputs_train(out, kv, self.out_norm)
        return AK.axial_attention(
            x_in, skip, self.to_kq, self.to_v, self.to_kq_bn.folded(),
            self.to_v_bn.folded(), r_q, r_k, r_v,
            self.attention_norm.folded(), self.out_norm.folded(),
            heads=self.heads, dkq=self.dkq, dv=self.dv, dtype=self.dtype)


def columns(x: torch.Tensor) -> torch.Tensor:
    """NCHW → (b·w, h, C): each column is a length-h sequence."""
    b, c, h, w = x.shape
    return x.permute(0, 3, 2, 1).reshape(b * w, h, c)


def columns_to_rows(cols: torch.Tensor, b: int, h: int,
                    w: int) -> torch.Tensor:
    """(b·w, h, C) → (b·h, w, C): each row is a length-w sequence."""
    c = cols.shape[-1]
    return cols.reshape(b, w, h, c).permute(0, 2, 1, 3).reshape(b * h, w, c)


def rows_to_nchw(rows: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    return rows.reshape(b, h, w, rows.shape[-1]).permute(0, 3, 1, 2)


class AxialAttentionBlock(PortModule):
    """Residual height-then-width axial attention block, NCHW, attending at
    width 512. With ``down_sample`` the attention branch is avg-pooled and
    the shortcut is a 3×3/2 conv with symmetric pad 1 and a bias."""

    def __init__(self, in_channels: int, out_channels: int, down_sample: bool,
                 dim: int, heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down_sample, self.dtype = down_sample, dtype
        d_in = 512
        self.in_conv = nn.Conv2d(in_channels, d_in, 1, bias=False)
        self.in_bn = BatchNorm(d_in, dtype)
        self.height_att = AxialAttention(dim, d_in, heads, dtype=dtype)
        self.width_att = AxialAttention(dim, d_in, heads, dtype=dtype)
        if down_sample:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 3)
            self.shortcut_bn = BatchNorm(out_channels, dtype)
            self.att_down_bn = BatchNorm(d_in, dtype)
        self.out_conv = nn.Conv2d(d_in, out_channels, 1, bias=False)
        self.out_bn = BatchNorm(out_channels, dtype)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = torch.relu(self.in_bn(conv2d(x_in, self.in_conv, dt)))
        b, _, h, w = x.shape
        cols = self.height_att(columns(x))
        rows = self.width_att(columns_to_rows(cols, b, h, w))
        x = rows_to_nchw(rows, b, h, w)
        shortcut = x_in
        if self.down_sample:
            shortcut = self.shortcut_bn(
                conv2d(x_in, self.shortcut_conv, dt, stride=2, padding=1))
            x = self.att_down_bn(F.avg_pool2d(x, 2))
        x = torch.relu(x)
        x = self.out_bn(conv2d(x, self.out_conv, dt))
        return torch.relu(x + shortcut)
