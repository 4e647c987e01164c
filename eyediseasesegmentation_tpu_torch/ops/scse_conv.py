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
:func:`scse_conv3x3_bn_relu_reference`; CUDA parts launch the kernel in
``csrc/scse_conv.cu`` (built on first use) or raise. The concat is never
materialized on the kernel route.

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

# Where the kernel's wrapper launches it, and nowhere else.
launches = 0


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


def _run(lib, stream, parts, gate_c, sse_kernel, sse_bias, k3, scale, bias,
         relu, gated):
    """Marshal one call of ``scse_conv3x3_fwd`` from ``lib``; returns
    (cudaError_t, output)."""
    parts, B, H, W, channels = check_parts("scse_conv3x3_bn_relu", parts)
    dtype, dev = parts[0].dtype, parts[0].device
    C, cout = sum(channels), int(k3.shape[0])
    if k3.shape[1] != C:
        raise ValueError(f"k3 {tuple(k3.shape)} does not match ΣC={C}")
    coutP = padded16(cout)
    gc, wsse, bsse = gate_operands(gate_c, sse_kernel, sse_bias, B, C, dev)
    w = tap_major(k3, dtype, C, coutP)
    s, b = affine(scale, bias, cout, dev)
    out = torch.empty((B, cout, H, W), dtype=dtype, device=dev)
    gmap, gmap_ptr = gate_map_scratch(gated, B, H, W, dev)
    ptrs, chs = part_arrays(parts, channels)
    rc = lib.scse_conv3x3_fwd(
        _DTYPE_CODES[dtype], len(parts), ptrs, chs, gc.data_ptr(),
        wsse.data_ptr(), bsse.data_ptr(), gmap_ptr, w.data_ptr(), s.data_ptr(),
        b.data_ptr(), out.data_ptr(), B, H, W, cout, coutP, int(relu),
        int(gated), ctypes.c_void_p(stream))
    del gmap        # alive until the launch above was enqueued
    return rc, out


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
    dtype.
    """
    del tile_rows
    parts = list(parts)
    if not on_cuda("scse_conv3x3_bn_relu", parts[0]):
        return scse_conv3x3_bn_relu_reference(
            parts, gate_c, sse_kernel, sse_bias, k3, scale, bias, relu, gated)
    global launches
    lib = _build.load("scse_conv")
    dev = parts[0].device
    with torch.cuda.device(dev):
        rc, out = _run(lib, torch.cuda.current_stream(dev).cuda_stream, parts,
                       gate_c, sse_kernel, sse_bias, k3, scale, bias, relu,
                       gated)
    if rc != 0:
        raise RuntimeError("scse_conv3x3_bn_relu kernel failed to launch: "
                           f"CUDA error {rc} (out {tuple(out.shape)})")
    launches += 1
    return out
