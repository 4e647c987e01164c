"""Shared model building blocks (torch, NCHW, eval only).

Counterpart of ``eyediseasesegmentation_tpu/models/modules/layers.py``. Every
module keeps its parameters in fp32 and computes in ``dtype``: weights are cast
at each call, as the flax modules do with ``param_dtype=float32``. Submodules
carry the flax scope names, so ``convert.flax_to_torch`` is a path walk.

Only inference is ported: modules are built in eval mode, and a forward in
training mode raises (see ROADMAP.md, "Train step").
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def _refuse_training(module, args):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only inference is ported; training "
            "comes with the train-step port (ROADMAP.md, 'Train step')")


class EvalModule(nn.Module):
    """Base of the port's modules: built in eval mode; a forward after
    ``.train()`` raises NotImplementedError."""

    def __init__(self):
        super().__init__()
        self.training = False
        self.register_forward_pre_hook(_refuse_training)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``conv`` applied in ``dtype`` (its fp32 weights cast for the call).
    The port's ``nn.Conv2d`` modules only hold OIHW weights; stride and
    padding are given here."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, stride, padding)


class BatchNorm(EvalModule):
    """Eval BatchNorm2d: running stats and affine folded in fp32 into one
    (scale, bias), applied in the compute dtype."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.folded()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)
        return y.to(self.dtype)


class ConvBNReLU(EvalModule):
    """conv 3×3 (SAME, no bias) → [DropBlock: identity at eval] → BN → ReLU.
    A list input is the channel concat of its parts."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x: Parts) -> torch.Tensor:
        x = torch.cat([p.to(self.dtype) for p in output_parts(x)], 1)
        y = conv2d(x, self.conv, self.dtype, padding=1)
        return torch.relu(self.bn(y))

    def folded_params(self):
        """(conv weight OIHW, folded BN scale, folded BN bias), all fp32,
        for a fused consumer (the JAX module's ``mode="pallas_params"``)."""
        scale, bias = self.bn.folded()
        return self.conv.weight, scale, bias


class SEBlock(EvalModule):
    """Squeeze-excite on pooled means (two Dense layers, reduction 16)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = max(channels // 16, 1)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        s = x.mean((2, 3))
        s = torch.relu(F.linear(s.to(dt), self.fc1.weight.to(dt),
                                self.fc1.bias.to(dt)))
        s = F.linear(s, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return x * torch.sigmoid(s)[:, :, None, None]


class SCSEAttention(EvalModule):
    """Concurrent spatial & channel SE (smp ``Attention('scse')``).

    A list input is the channel concat of its parts and returns the gated
    parts. The cSE reduction is 16. The sSE 1×1 conv runs as a channel
    reduce of compute-dtype products summed in fp32, as the JAX module
    computes it.
    """

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = max(channels // 16, 1)
        self.cse_reduce = nn.Conv2d(channels, mid, 1)
        self.cse_expand = nn.Conv2d(mid, channels, 1)
        self.sse = nn.Conv2d(channels, 1, 1)

    def _cse_logits(self, parts: List[torch.Tensor],
                    mean_override: Optional[torch.Tensor]) -> torch.Tensor:
        """Channel-SE logits (B, ΣC, 1, 1) from the pooled means, or from
        ``mean_override``: (B, ΣC) fp32 means that a fused producer already
        summed, cast to the input's dtype."""
        dt = self.dtype
        if mean_override is not None:
            s = mean_override[:, :, None, None].to(parts[0].dtype)
        else:
            s = torch.cat([p.mean((2, 3), keepdim=True) for p in parts], 1)
        s = torch.relu(conv2d(s, self.cse_reduce, dt))
        return conv2d(s, self.cse_expand, dt)

    def raw_gates(self, parts: Parts, up_part0: bool = True):
        """(gate_c (B, ΣC) fp32 already sigmoided, sse_kernel (ΣC,) fp32,
        sse_bias scalar fp32) for a fused consumer that computes the spatial
        gate itself. The sigmoid runs in the compute dtype and is then
        upcast. With ``up_part0`` part 0 is the map BEFORE its ×2 upsample:
        its pooled mean equals the upsampled map's (bilinear weights sum to
        one per source pixel pair), so the big upsampled map is never read
        here; the flag records that contract and changes no arithmetic."""
        del up_part0
        s = self._cse_logits(output_parts(parts), None)
        gate_c = torch.sigmoid(s).to(torch.float32).flatten(1)
        return gate_c, self.sse.weight[0, :, 0, 0], self.sse.bias[0]

    def forward(self, x: Parts, mean_override: Optional[torch.Tensor] = None):
        dt = self.dtype
        parts = output_parts(x)
        s = self._cse_logits(parts, mean_override)
        w = self.sse.weight[0, :, 0, 0].to(dt)
        t, off = None, 0
        for p in parts:
            c = p.shape[1]
            tp = (p.to(dt) * w[off:off + c, None, None]).sum(
                1, keepdim=True, dtype=torch.float32)
            t = tp if t is None else t + tp
            off += c
        gate_s = torch.sigmoid(t + self.sse.bias.to(t.dtype))
        gate_c = torch.sigmoid(s)
        out, off = [], 0
        for p in parts:
            c = p.shape[1]
            out.append(p * (gate_c[:, off:off + c] + gate_s))
            off += c
        return out if isinstance(x, (list, tuple)) else out[0]


def Attention(attention_type: Optional[str], channels: int,
              dtype: torch.dtype = torch.float32) -> nn.Module:
    """smp-style attention: None → identity, 'scse' → :class:`SCSEAttention`
    (the flax ``Attention`` wrapper's only child, so it takes its place)."""
    if attention_type is None:
        return nn.Identity()
    if attention_type == "scse":
        return SCSEAttention(channels, dtype=dtype)
    raise ValueError(f"Unknown attention type {attention_type}")


class SegmentationHead(EvalModule):
    """3×3 conv (SAME, bias) to class logits, returned in fp32."""

    def __init__(self, cin: int, classes: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, classes, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.conv, self.dtype, padding=1).to(torch.float32)


class ClassificationHead(EvalModule):
    """Global average pool → [dropout: identity at eval] → linear, in
    fp32."""

    def __init__(self, cin: int, classes: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(cin, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3))
        dt = self.dtype
        s = F.linear(s.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        return s.to(torch.float32)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 at half-pixel centres with edge clamp, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample2x_w(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 along W only (the W half of :func:`upsample2x`: same
    half-pixel centres and edge clamp), NCHW → (N, C, H, 2W)."""
    return F.interpolate(x, scale_factor=(1, 2), mode="bilinear",
                         align_corners=False)


def output_parts(x: Parts) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]
