"""scSE-gated 3×3 conv over a virtual concat: kernel wrapper and plain version.

Counterpart of ``eyediseasesegmentation_tpu/ops/pallas_scse_conv.py``: the
decode node's attention1 + conv1 + BN + ReLU stage in eval mode,

    t    = Σ_c fp32(x_c) · sse_kernel[c]          (x = cat(parts), virtual)
    gate = gate_c[b, c] + sigmoid(t + sse_bias)   (fp32)
    y    = relu?(scale · conv3×3_SAME(x · T(gate)) + bias)

with the gating product in the parts' dtype T, fp32 accumulation, the affine
and ReLU in fp32 and the output in T. Maps are NCHW here (NHWC in the JAX
package) and the conv weight is torch's OIHW ``(cout, ΣC, 3, 3)``; names and
argument order follow the JAX function. Parts on the CPU take
:func:`scse_conv3x3_bn_relu_reference`; CUDA parts launch a kernel in
``csrc/scse_conv.cu`` (built on first use) or raise. The concat is never
materialized on the kernel route.

Two kernels, chosen by :func:`variant` from the dtype, the width, the
alignment and the channel counts of the parts alone: ``"sm90"`` (bf16, W % 8
== 0, 16-byte-aligned parts, every part a multiple of 16 channels: TMA,
mbarriers and wgmma, the gate applied by the producer warps) and ``"wmma"``
(fp32, and bf16 of other shapes: the wmma / FMA kernel over
``csrc/decode_conv.cuh``). A non-zero return code raises; nothing falls back
to the other kernel.

The helpers here also serve ``ops/conv.py`` and ``ops/decode_pair.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PARTS = 8
VARIANTS = {"wmma": 0, "sm90": 1}
_SM90_K, _SM90_N = 16, 64          # input channels per stage, outputs per pass

# Where the wrapper launches a kernel, and nowhere else: the total and each
# variant's count.
launches = 0
launches_sm90 = 0
launches_wmma = 0


def variant(dtype, width: int, data_ptrs: Sequence[int],
            part_channels: Sequence[int]) -> str:
    """The kernel that takes parts of ``dtype`` and ``width`` whose data
    start at ``data_ptrs``, with ``part_channels`` channels: ``"sm90"``
    where the TMA can read every part (bf16, rows of a multiple of 16
    bytes, 16-byte-aligned bases) and no 16-channel chunk straddles two
    parts, else ``"wmma"``."""
    if (dtype == torch.bfloat16 and width % 8 == 0
            and all(p % 16 == 0 for p in data_ptrs)
            and all(c % _SM90_K == 0 for c in part_channels)):
        return "sm90"
    return "wmma"


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def gated_concat(parts: Sequence[torch.Tensor], gate_c, sse_kernel, sse_bias,
                 gated: bool = True) -> torch.Tensor:
    """``cat(parts) · T(gate_c + sigmoid(sSE logit))``: the logit summed in
    fp32 from the parts' values, the product in the parts' dtype."""
    parts = list(parts)
    if not gated:
        return torch.cat(parts, 1)
    w = sse_kernel.to(_F32)
    t, off = None, 0
    for p in parts:
        c = p.shape[1]
        tp = torch.einsum("bchw,c->bhw", p.to(_F32), w[off:off + c])
        t = tp if t is None else t + tp
        off += c
    gate_s = torch.sigmoid(t + sse_bias.to(_F32).reshape(()))[:, None]
    out, off = [], 0
    for p in parts:
        c = p.shape[1]
        gate = gate_c[:, off:off + c].to(_F32)[:, :, None, None] + gate_s
        out.append(p * gate.to(p.dtype))
        off += c
    return torch.cat(out, 1)


def conv_affine(x: torch.Tensor, w: torch.Tensor, scale, bias,
                relu: bool) -> torch.Tensor:
    """fp32 ``relu?(scale · conv3×3_SAME(x) + bias)`` of the values of ``x``
    and of ``w`` rounded to ``x.dtype``: exact products, fp32 sums (TF32 off
    on a GPU)."""
    cout = w.shape[0]
    wt = w.to(x.dtype).to(_F32)
    keep = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.to(_F32), wt, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = keep
    if scale is not None:
        y = y * scale.to(_F32).view(1, cout, 1, 1)
    if bias is not None:
        y = y + bias.to(_F32).view(1, cout, 1, 1)
    return torch.relu(y) if relu else y


def scse_conv3x3_bn_relu_reference(parts, gate_c, sse_kernel, sse_bias, k3,
                                   scale=None, bias=None, relu: bool = True,
                                   gated: bool = True) -> torch.Tensor:
    """Plain PyTorch version: cat + gate + ``F.conv2d`` + affine + ReLU."""
    x = gated_concat(parts, gate_c, sse_kernel, sse_bias, gated)
    return conv_affine(x, k3, scale, bias, relu).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel route
# ---------------------------------------------------------------------------

def check_parts(name: str, parts: Sequence[torch.Tensor],
                up_part0: bool = False):
    """Validate the parts of a kernel call; returns (contiguous parts, B, H,
    W, channel counts)."""
    parts = list(parts)
    if not 1 <= len(parts) <= _MAX_PARTS:
        raise ValueError(f"{name} kernel: takes 1 to {_MAX_PARTS} parts, got "
                         f"{len(parts)}")
    dtype, dev = parts[0].dtype, parts[0].device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    if any(p.dtype != dtype or p.device != dev or p.ndim != 4 for p in parts):
        raise ValueError(f"{name} kernel: parts must be 4-D maps of one dtype "
                         "on one device, got "
                         f"{[(tuple(p.shape), p.dtype) for p in parts]}")
    B, _, H, W = parts[0].shape
    if up_part0:
        H *= 2
    want = [(B, H // 2 if (up_part0 and i == 0) else H, W)
            for i in range(len(parts))]
    got = [(p.shape[0], p.shape[2], p.shape[3]) for p in parts]
    if got != want or min(B, H, W) < 1:
        raise ValueError(f"{name} kernel: part shapes "
                         f"{[tuple(p.shape) for p in parts]} do not agree "
                         f"(up_part0={up_part0})")
    return ([p.contiguous() for p in parts], B, H, W,
            [int(p.shape[1]) for p in parts])


def tap_major(w: torch.Tensor, dtype, rows: int, cols: int) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` → the kernels' ``(9, rows, cols)`` in
    ``dtype``, tap-major, zero-padded from (cin, cout)."""
    cout, cin = w.shape[:2]
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv weight must be (cout, cin, 3, 3), got "
                         f"{tuple(w.shape)}")
    wt = w.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout)
    return F.pad(wt, (0, cols - cout, 0, rows - cin)).contiguous()


def affine(scale, bias, cout: int, device):
    """(scale, bias) as contiguous fp32 vectors; None is the identity."""
    s = (torch.ones(cout, dtype=_F32, device=device) if scale is None
         else scale.to(device=device, dtype=_F32).reshape(cout).contiguous())
    b = (torch.zeros(cout, dtype=_F32, device=device) if bias is None
         else bias.to(device=device, dtype=_F32).reshape(cout).contiguous())
    return s, b


def gate_operands(gate_c, sse_kernel, sse_bias, B: int, C: int, device):
    """(gate_c (B, C), sse_kernel (C,), sse_bias (1,)) as contiguous fp32
    tensors on ``device``."""
    if tuple(gate_c.shape) != (B, C) or sse_kernel.numel() != C:
        raise ValueError(f"gate_c {tuple(gate_c.shape)} / sse_kernel "
                         f"{tuple(sse_kernel.shape)} do not match B={B}, "
                         f"ΣC={C}")
    def f32(t):
        return torch.as_tensor(t).to(device=device, dtype=_F32).contiguous()
    return f32(gate_c), f32(sse_kernel).reshape(C), f32(sse_bias).reshape(1)


def part_arrays(parts: List[torch.Tensor], channels: List[int]):
    """ctypes arrays of the parts' pointers and channel counts."""
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    chs = (ctypes.c_int * len(parts))(*channels)
    return ptrs, chs


def gate_map_scratch(gated: bool, B: int, H: int, W: int, device):
    """(tensor, pointer) of the (B, H, W) fp32 scratch for the kernels'
    spatial gate; (None, None) when there is no gate. The caller keeps the
    tensor until its launch is enqueued."""
    if not gated:
        return None, None
    gmap = torch.empty((B, H, W), dtype=_F32, device=device)
    return gmap, gmap.data_ptr()


def padded16(n: int) -> int:
    return -(-n // 16) * 16


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of rows of 64 bf16 values (last dim), the row
    index being the second-to-last dim: 16-byte piece j of row k moves to
    piece j ^ (k % 8). Its own inverse."""
    k = torch.arange(t.shape[-2], device=t.device)[:, None] % 8
    src = torch.arange(8, device=t.device)[None, :] ^ k
    pieces = t.reshape(*t.shape[:-1], 8, 8)
    idx = src[..., None].expand(*pieces.shape[-3:]).expand_as(pieces)
    return torch.gather(pieces, -2, idx).reshape(t.shape)


def sm90_weight_operand(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` → the sm90 kernels' B operand in bf16,
    ``(ceil(cout/64), ceil(cin/16), 9, 16, 64)``: for each pass of 64 output
    channels and chunk of 16 input channels, the 9 taps' (16 x 64) weight
    matrices as 128-byte rows of output channels, zero-padded, with the
    128-byte swizzle that wgmma's N-major operand expects (one bulk copy per
    chunk lands it as the kernel reads it)."""
    cout, cin = int(w.shape[0]), int(w.shape[1])
    npass, nchunk = -(-cout // _SM90_N), -(-cin // _SM90_K)
    wt = tap_major(w, torch.bfloat16, nchunk * _SM90_K, npass * _SM90_N)
    wt = wt.view(9, nchunk, _SM90_K, npass, _SM90_N).permute(3, 1, 0, 2, 4)
    return _swizzle128(wt.contiguous()).contiguous()


def conv_weights(var: str, w: torch.Tensor, dtype, device):
    """(weight operand, coutP) of a variant: the sm90 B operand with cout
    padded to passes of 64, or the tap-major matrix padded to 16."""
    cout, cin = int(w.shape[0]), int(w.shape[1])
    if var == "sm90":
        wt = sm90_weight_operand(w).to(device)
        return wt, int(wt.shape[0]) * _SM90_N
    return tap_major(w, dtype, cin, padded16(cout)), padded16(cout)


def _run(lib, stream, parts, gate_c, sse_kernel, sse_bias, k3, scale, bias,
         relu, gated):
    """Marshal one call of ``scse_conv3x3_fwd`` from ``lib``, with the
    kernel :func:`variant` picks; returns (cudaError_t, output, variant)."""
    parts, B, H, W, channels = check_parts("scse_conv3x3_bn_relu", parts)
    dtype, dev = parts[0].dtype, parts[0].device
    C, cout = sum(channels), int(k3.shape[0])
    if k3.shape[1] != C:
        raise ValueError(f"k3 {tuple(k3.shape)} does not match ΣC={C}")
    var = variant(dtype, W, [p.data_ptr() for p in parts], channels)
    gc, wsse, bsse = gate_operands(gate_c, sse_kernel, sse_bias, B, C, dev)
    w, coutP = conv_weights(var, k3, dtype, dev)
    s, b = affine(scale, bias, cout, dev)
    out = torch.empty((B, cout, H, W), dtype=dtype, device=dev)
    gmap, gmap_ptr = gate_map_scratch(gated, B, H, W, dev)
    ptrs, chs = part_arrays(parts, channels)
    rc = lib.scse_conv3x3_fwd(
        _DTYPE_CODES[dtype], VARIANTS[var], len(parts), ptrs, chs,
        gc.data_ptr(),
        wsse.data_ptr(), bsse.data_ptr(), gmap_ptr, w.data_ptr(), s.data_ptr(),
        b.data_ptr(), out.data_ptr(), B, H, W, cout, coutP, int(relu),
        int(gated), ctypes.c_void_p(stream))
    del gmap        # alive until the launch above was enqueued
    return rc, out, var


def on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; raises for any
    other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return True


def scse_conv3x3_bn_relu(parts: Sequence[torch.Tensor], gate_c, sse_kernel,
                         sse_bias, k3, scale: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         relu: bool = True, gated: bool = True,
                         tile_rows: Optional[int] = None) -> torch.Tensor:
    """Fused scSE gate → 3×3 SAME conv (virtual concat) → affine → ReLU.

    parts: (B, c_i, H, W) maps at output resolution, one dtype (part 0
    already ×2-upsampled). gate_c: (B, ΣC) fp32, already sigmoided.
    sse_kernel: (ΣC,); sse_bias: scalar. k3: (cout, ΣC, 3, 3); scale/bias:
    (cout,) folded BN (None = identity). ``gated=False`` skips the gate.
    ``tile_rows`` (the TPU kernel's row-tile knob) is accepted and ignored:
    the CUDA kernel's tile is fixed. Returns (B, cout, H, W) in the parts'
    dtype. Raises under grad mode when an input requires grad (no
    backward).
    """
    del tile_rows
    parts = list(parts)
    _build.refuse_autograd("scse_conv3x3_bn_relu", parts, gate_c,
                           sse_kernel, sse_bias, k3, scale, bias)
    if not on_cuda("scse_conv3x3_bn_relu", parts[0]):
        return scse_conv3x3_bn_relu_reference(
            parts, gate_c, sse_kernel, sse_bias, k3, scale, bias, relu, gated)
    global launches, launches_sm90, launches_wmma
    lib = _build.load("scse_conv")
    dev = parts[0].device
    with torch.cuda.device(dev):
        rc, out, var = _run(lib, torch.cuda.current_stream(dev).cuda_stream,
                            parts, gate_c, sse_kernel, sse_bias, k3, scale,
                            bias, relu, gated)
    if rc != 0:
        raise RuntimeError(f"scse_conv3x3_bn_relu {var} kernel failed to "
                           f"launch: CUDA error {rc} (out {tuple(out.shape)})")
    launches += 1
    if var == "sm90":
        launches_sm90 += 1
    else:
        launches_wmma += 1
    return out
