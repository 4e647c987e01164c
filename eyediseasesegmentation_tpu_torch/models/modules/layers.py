"""Shared model building blocks (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/modules/layers.py``. Every
module keeps its parameters in fp32 and computes in ``dtype``: weights are cast
at each call, as the flax modules do with ``param_dtype=float32``. Submodules
carry the flax scope names, so ``convert.flax_to_torch`` is a path walk.

Modules are built in eval mode; ``.train()`` switches them to the JAX
package's ``train=True`` behaviour: batch statistics in the BatchNorms (and
their running update), DropBlock in ``ConvBNReLU`` and dropout in the
classification head. The noise of those draws comes from the module's
``generator`` (see :func:`set_generator`); the packed layouts of the JAX
package (``packed > 1``) are exact rewrites with no counterpart here.

Under ``parallel.mesh.data_parallel`` a train forward is one rank's share
of a batch split over the ranks, and what JAX computes over the logical
global batch is computed over it here too: the BatchNorms' statistics from
all-reduced sums and counts (differentiably), and DropBlock's and
dropout's masks drawn for the whole batch, this rank's rows kept, so their
generators advance as they would at world size 1.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...parallel import mesh as P

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


class PortModule(nn.Module):
    """Base of the port's modules: built in eval mode (call ``.train()``
    for the train forward)."""

    def __init__(self):
        super().__init__()
        self.training = False


class NoiseModule(PortModule):
    """A module whose train forward draws noise from ``self.generator``
    (``None``: the default generator of the input's device)."""

    def __init__(self):
        super().__init__()
        self.generator: Optional[torch.Generator] = None


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Give every noise-drawing module of ``model`` the generator its next
    train forwards draw from (on the device of the model's inputs)."""
    for mod in model.modules():
        if isinstance(mod, NoiseModule):
            mod.generator = generator


class _RematState(threading.local):
    recomputing = False


_REMAT = _RematState()


def recomputing() -> bool:
    """Whether a :func:`remat` block is being recomputed for the backward
    (in the thread that runs it): the norms then compute their batch
    statistics again but leave their running statistics alone, as flax's
    ``nn.remat`` moves them once."""
    return _REMAT.recomputing


def remat(block: nn.Module, *args, enabled: bool = True):
    """``block(*args)``, its activations recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant) when ``enabled``,
    ``block`` is in train mode and a gradient is being recorded; else a
    plain call. Two traps are guarded. The recompute runs under
    :func:`recomputing`, so BatchNorm's running statistics move once. The
    explicit generators of the block's noise modules (``set_generator``;
    ``checkpoint`` replays only the default generators) are put back to
    their state at the forward for the recompute, so DropBlock and dropout
    draw the same masks, and then left where the backward found them."""
    if not (enabled and block.training and torch.is_grad_enabled()):
        return block(*args)
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if isinstance(m, NoiseModule)
                 and m.generator is not None}.values())
    at_forward = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, at_forward):
            g.set_state(st)
        outer, _REMAT.recomputing = _REMAT.recomputing, True
        try:
            yield
        finally:
            _REMAT.recomputing = outer
            for g, st in zip(gens, now):
                g.set_state(st)

    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


def wide(dtype: torch.dtype) -> torch.dtype:
    """fp32, or the dtype itself where it is wider (fp64): the dtype of
    statistics, gate sums and logits, so that an fp64 model stays fp64."""
    return torch.promote_types(dtype, torch.float32)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``conv`` applied in ``dtype`` (its fp32 weights cast for the call).
    The port's ``nn.Conv2d`` modules hold OIHW weights, their groups and
    dilation; stride and padding are given here."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, stride, padding,
                    conv.dilation, conv.groups)


def conv2d_same(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
                stride: int = 1) -> torch.Tensor:
    """:func:`conv2d` with flax's ``padding="SAME"`` for an undilated
    square kernel: per axis the total ``max((out − 1)·stride + k − in, 0)``
    with ``out = ⌈in / stride⌉``, the low side ``total // 2`` and the high
    side the rest. Asymmetric for an even kernel and for a stride-2 conv on
    an even map (3×3: (0, 1)); there zeros are added by ``F.pad`` first,
    elsewhere the pad goes to the conv."""
    k, pads = conv.kernel_size[0], []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if len(set(pads)) == 1:
        return conv2d(x, conv, dtype, stride, pads[0])
    return conv2d(F.pad(x, pads), conv, dtype, stride)


def linear(x: torch.Tensor, dense: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """``dense`` over the last axis in ``dtype`` (flax ``nn.Dense``)."""
    bias = None if dense.bias is None else dense.bias.to(dtype)
    return F.linear(x.to(dtype), dense.weight.to(dtype), bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is the
    exact erf form, about 1e-3 away)."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), statistics and affine in fp32 (or wider), the output
    in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = wide(x.dtype)
        return F.layer_norm(x.to(w), self.normalized_shape,
                            self.weight.to(w), self.bias.to(w),
                            self.eps).to(self.dtype)


def batch_moments(x: torch.Tensor, axes) -> tuple:
    """Batch mean and biased variance ``E[x²] − E[x]²`` over ``axes`` in
    fp32 (fp64 for an fp64 input), as the JAX package computes them. Under
    ``data_parallel`` (``axes`` hold the batch axis) the moments are those
    of the whole batch: the ranks' sums, all-reduced, over the global
    count."""
    xf = x.to(wide(x.dtype))
    mesh = P.active_data_mesh()
    if mesh is None:
        mean = xf.mean(axes)
        return xf, mean, (xf * xf).mean(axes) - mean * mean
    sums = P.psum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), mesh)
    n = batch_count(x, axes)
    mean = sums[0] / n
    return xf, mean, sums[1] / n - mean * mean


def batch_count(x: torch.Tensor, axes) -> int:
    """The elements per channel that :func:`batch_moments` reduces over:
    the whole batch's under ``data_parallel``."""
    n = int(np.prod([x.shape[a] for a in axes]))
    mesh = P.active_data_mesh()
    return n if mesh is None else n * mesh.axis_size()


def global_rows(n_local: int):
    """(rows of the whole batch, this rank's slice of them) under
    ``data_parallel``; (n_local, None) outside it."""
    mesh = P.active_data_mesh()
    if mesh is None:
        return n_local, None
    n = n_local * mesh.axis_size()
    return n, P.batch_rows(mesh, n)


class BatchNorm(PortModule):
    """BatchNorm2d with fp32 statistics.

    Eval (and ``frozen``, the reference's frozen BN on pretrained layers):
    running stats and affine folded in fp32 into one (scale, bias), applied
    in the compute dtype. Train: batch mean and **biased** variance in fp32
    over (N, H, W); the running stats move by ``ra = 0.9·ra + 0.1·batch``
    (flax ``momentum=0.9``), the variance biased too, unlike
    ``nn.BatchNorm2d``, which stores the unbiased one; not while a
    :func:`remat` block is recomputed. The output is cast to the compute
    dtype."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 frozen: bool = False, momentum: float = 0.9):
        super().__init__()
        self.dtype, self.frozen, self.momentum = dtype, frozen, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if not self.training or self.frozen:
            scale, bias = self.folded()
            y = (x * scale.to(x.dtype).view(shape)
                 + bias.to(x.dtype).view(shape))
            return y.to(self.dtype)
        axes = (0,) + tuple(range(2, x.ndim))
        xf, mean, var = batch_moments(x, axes)
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = ((xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
             * self.weight.view(shape) + self.bias.view(shape))
        return y.to(self.dtype)


def dropblock_gamma(drop_prob: float, h: int, w: int,
                    block_size: int = 7) -> float:
    """Bernoulli rate of the block centres (timm DropBlock2d), the block
    clipped to the map."""
    bs = min(block_size, h, w)
    valid = (h - bs + 1) * (w - bs + 1)
    return drop_prob * h * w / (bs ** 2) / max(valid, 1)


def drop_block(x: torch.Tensor, centres: torch.Tensor,
               block_size: int = 7, rows: Optional[slice] = None
               ) -> torch.Tensor:
    """Apply DropBlock with the drawn block ``centres`` ((N, 1, H, W) in
    {0, 1}): centres grow to ``block_size``² blocks by a stride-1 SAME
    max-pool, the kept elements are renormalised by
    ``keep.numel() / max(Σ keep, 1)``. ``rows``: ``centres`` are the whole
    batch's, ``x`` holds these rows of it (the norm is the whole
    batch's)."""
    h, w = x.shape[2], x.shape[3]
    bs = min(block_size, h, w)
    lo = (bs - 1) // 2
    c = F.pad(centres.to(x.dtype), (lo, bs - 1 - lo, lo, bs - 1 - lo))
    keep = 1.0 - F.max_pool2d(c, bs, stride=1)
    norm = keep.numel() / torch.clamp(keep.sum(), min=1.0)
    if rows is not None:
        keep = keep[rows]
    return x * keep * norm.to(x.dtype)


class DropBlock2d(NoiseModule):
    """Structured dropout over contiguous blocks (timm semantics), the
    identity in eval or at ``drop_prob`` 0. Train: block centres drawn
    Bernoulli(:func:`dropblock_gamma`) per (sample, pixel), shared across
    channels, then :func:`drop_block`."""

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size

    def draw(self, x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
        """The centres of ``n`` samples (default: ``x``'s batch) of
        ``x``'s map size."""
        _, _, h, w = x.shape
        n = x.shape[0] if n is None else n
        gamma = dropblock_gamma(self.drop_prob, h, w, self.block_size)
        u = torch.rand((n, 1, h, w), generator=self.generator,
                       device=x.device)
        return (u < gamma).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_prob <= 0.0:
            return x
        n, rows = global_rows(x.shape[0])
        if rows is None:
            return drop_block(x, self.draw(x), self.block_size)
        return drop_block(x, self.draw(x, n), self.block_size, rows)


class Dropout(NoiseModule):
    """flax's ``nn.Dropout``, the identity in eval or at ``rate`` 0. Train:
    each element kept with probability ``1 − rate`` (:meth:`draw`) and the
    kept ones scaled by its inverse (:func:`dropout`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        return draw_keep(x, self.rate, self.generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        return dropout(x, self.draw(x), self.rate)


def draw_keep(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout's keep mask of ``x``'s shape (kept with probability
    ``1 − rate``); under ``data_parallel`` drawn for the whole batch, this
    rank's rows kept."""
    n, rows = global_rows(x.shape[0])
    u = torch.rand((n,) + tuple(x.shape[1:]), generator=generator,
                   device=x.device)
    return (u if rows is None else u[rows]) < 1.0 - rate


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Apply dropout with the drawn ``keep`` mask (bool, ``x``'s shape)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvBNReLU(PortModule):
    """conv ``kernel_size``² at ``strides`` (flax SAME: asymmetric for an
    even kernel and for a stride-2 conv on an even map, no bias) →
    DropBlock → BN → ReLU. A list input is the channel concat of its
    parts."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32,
                 drop_block_prob: float = 0.1, kernel_size: int = 3,
                 strides: int = 1):
        super().__init__()
        self.dtype, self.strides = dtype, strides
        self.conv = nn.Conv2d(cin, cout, kernel_size, bias=False)
        self.drop_block = DropBlock2d(drop_block_prob, block_size=7)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x: Parts) -> torch.Tensor:
        x = torch.cat([p.to(self.dtype) for p in output_parts(x)], 1)
        y = conv2d_same(x, self.conv, self.dtype, self.strides)
        return torch.relu(self.bn(self.drop_block(y)))

    def folded_params(self):
        """(conv weight OIHW, folded BN scale, folded BN bias), all fp32,
        for a fused consumer (the JAX module's ``mode="pallas_params"``)."""
        scale, bias = self.bn.folded()
        return self.conv.weight, scale, bias


class SEBlock(PortModule):
    """Squeeze-excite on pooled means (two Dense layers, ``channels`` →
    ``channels // reduction`` → ``channels``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 reduction: int = 16):
        super().__init__()
        self.dtype = dtype
        mid = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(linear(x.mean((2, 3)), self.fc1, self.dtype))
        s = linear(s, self.fc2, self.dtype)
        return x * torch.sigmoid(s)[:, :, None, None]


class SCSEAttention(PortModule):
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
                1, keepdim=True, dtype=wide(dt))
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


class SegmentationHead(PortModule):
    """``kernel_size``² conv (SAME, bias) to class logits, then bilinear
    ×``upsampling`` in the compute dtype, returned in fp32 (or wider)."""

    def __init__(self, cin: int, classes: int = 1,
                 dtype: torch.dtype = torch.float32, kernel_size: int = 3,
                 upsampling: int = 1):
        super().__init__()
        self.dtype, self.upsampling = dtype, upsampling
        self.conv = nn.Conv2d(cin, classes, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.conv, self.dtype)
        if self.upsampling > 1:
            y = upsample(y, self.upsampling)
        return y.to(wide(self.dtype))


class ClassificationHead(NoiseModule):
    """Global average pool → dropout (``dropout``, train only) → linear,
    returned in fp32 (or wider). The dropout keeps each pooled value with
    probability ``1 − dropout`` and scales the kept ones by its inverse, as
    flax's ``nn.Dropout``."""

    def __init__(self, cin: int, classes: int = 1, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.fc1 = nn.Linear(cin, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3))
        if self.training and self.dropout > 0.0:
            s = dropout(s, draw_keep(s, self.dropout, self.generator),
                        self.dropout)
        dt = self.dtype
        s = F.linear(s.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        return s.to(wide(dt))


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear ×``factor`` at half-pixel centres with edge clamp, NCHW (the
    JAX package's ``jax.image.resize(..., "bilinear")`` to the multiple,
    which does not antialias when it enlarges)."""
    return resize_to(x, (factor * x.shape[2], factor * x.shape[3]))


# PyTorch's bilinear kernels index their output with 32-bit integers
RESIZE_OUT_LIMIT = 2 ** 31 - 1


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize to ``hw`` at half-pixel centres with edge clamp and
    no antialias, NCHW: ``jax.image.resize(..., "bilinear")`` where it
    enlarges (the zoo's resizes only enlarge, 1×1 included). An output of
    ``RESIZE_OUT_LIMIT`` elements or more (UNet 3+'s 1024-channel map at
    1024², 8 views) is resized per sample and channel block into one
    tensor of the input's memory format."""
    hw = tuple(hw)
    if tuple(x.shape[2:]) == hw:
        return x
    n, c = x.shape[:2]
    if n * c * hw[0] * hw[1] < RESIZE_OUT_LIMIT:
        return F.interpolate(x, size=hw, mode="bilinear",
                             align_corners=False, antialias=False)
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty((n, c) + hw, dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    step = max(min(c, (RESIZE_OUT_LIMIT - 1) // (hw[0] * hw[1])), 1)
    for i in range(n):
        for j in range(0, c, step):
            out[i:i + 1, j:j + step] = F.interpolate(
                x[i:i + 1, j:j + step], size=hw, mode="bilinear",
                align_corners=False, antialias=False)
    return out


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 at half-pixel centres with edge clamp, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample2x_w(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 along W only (the W half of :func:`upsample2x`: same
    half-pixel centres and edge clamp), NCHW → (N, C, H, 2W)."""
    return F.interpolate(x, scale_factor=(1, 2), mode="bilinear",
                         align_corners=False)


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool, stride 2, no padding (odd edges dropped)."""
    return F.max_pool2d(x, 2, stride=2)


def output_parts(x: Parts) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


# The modules below keep flax's auto-names for their children (``Conv_0``,
# ``BatchNorm_0``, ``ConvBNReLU_0``, ...): ``convert.py`` renames an
# auto-name only inside the module kinds that the port names apart.

class CBAMSpatial(PortModule):
    """CBAM spatial attention: the channel mean and max, a
    ``kernel_size``² conv (SAME, bias) to one map, and its sigmoid as the
    gate."""

    def __init__(self, kernel_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(2, 1, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        a = conv2d_same(a, self.Conv_0, self.dtype)
        return x * torch.sigmoid(a)


class CBAMChannel(PortModule):
    """CBAM channel attention: one two-Dense MLP (``channels`` →
    ``channels // reduction`` → ``channels``, ReLU between) on the spatial
    mean and on the spatial max, and ``sigmoid(avg + max)`` as the gate.
    Its flax children ``Dense_0`` / ``Dense_1`` are SEBlock's, so convert
    names them ``fc1`` / ``fc2`` here too."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(channels, max(channels // reduction, 1))
        self.fc2 = nn.Linear(self.fc1.out_features, channels)

    def mlp(self, s: torch.Tensor) -> torch.Tensor:
        s = torch.relu(linear(s, self.fc1, self.dtype))
        return linear(s, self.fc2, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.mlp(x.mean((2, 3))) + self.mlp(x.amax((2, 3)))
        return x * torch.sigmoid(a)[:, :, None, None]


class CBAM(PortModule):
    """CBAM: the channel gate, then the spatial gate (7×7)."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.CBAMChannel_0 = CBAMChannel(channels, reduction, dtype)
        self.CBAMSpatial_0 = CBAMSpatial(dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CBAMSpatial_0(self.CBAMChannel_0(x))


class AttentionGate(PortModule):
    """Additive attention gate (Attention U-Net): the skip ``x`` times
    σ(BN(ψ(ReLU(W_g g + W_x x)))), every conv 1×1 with a bias. ``g`` is the
    gating signal from the decoder, at the skip's size."""

    def __init__(self, g_channels: int, x_channels: int, inter: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(g_channels, inter, 1)
        self.Conv_1 = nn.Conv2d(x_channels, inter, 1)
        self.Conv_2 = nn.Conv2d(inter, 1, 1)
        self.BatchNorm_0 = BatchNorm(1, dtype)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        a = torch.relu(conv2d(g, self.Conv_0, dt) + conv2d(x, self.Conv_1, dt))
        a = self.BatchNorm_0(conv2d(a, self.Conv_2, dt))
        return x * torch.sigmoid(a)


class ASPP(PortModule):
    """Atrous spatial pyramid pooling: a 1×1 branch, 3×3 branches dilated
    by ``rates``, and image pooling (global mean, 1×1, broadcast), each to
    ``features`` channels with BN and ReLU, concatenated and projected by a
    1×1."""

    def __init__(self, cin: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.rates = dtype, tuple(rates)
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, dtype, 0.0, 1)
        for i, rate in enumerate(self.rates):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, features, 3,
                                                   bias=False, dilation=rate))
            self.add_module(f"BatchNorm_{i}", BatchNorm(features, dtype))
        self.ConvBNReLU_1 = ConvBNReLU(cin, features, dtype, 0.0, 1)
        self.ConvBNReLU_2 = ConvBNReLU((len(self.rates) + 2) * features,
                                       features, dtype, 0.0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.ConvBNReLU_0(x)]
        for i, rate in enumerate(self.rates):
            y = conv2d(x, getattr(self, f"Conv_{i}"), self.dtype,
                       padding=rate)
            outs.append(torch.relu(getattr(self, f"BatchNorm_{i}")(y)))
        p = self.ConvBNReLU_1(x.mean((2, 3), keepdim=True))
        outs.append(p.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.ConvBNReLU_2(outs)


class DoubleConv(PortModule):
    """(conv 3×3 → BN → ReLU) twice, the classic U-Net block."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, dtype, 0.0)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, dtype, 0.0)

    def forward(self, x: Parts) -> torch.Tensor:
        return self.ConvBNReLU_1(self.ConvBNReLU_0(x))
