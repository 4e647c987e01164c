"""3×3 conv + affine + ReLU: kernel wrapper and plain version.

Counterpart of ``eyediseasesegmentation_tpu/ops/pallas_conv.py``:
``y = relu?(scale · conv3×3_SAME(x) + bias)`` with fp32 accumulation and the
output in the input's dtype. No model calls it; it is the plain-convolution
baseline beside the gated kernels. Maps are NCHW and the weight is OIHW
``(cout, cin, 3, 3)``. A CPU tensor takes :func:`conv3x3_bn_relu_reference`;
a CUDA tensor launches a kernel in ``csrc/conv3x3.cu`` or raises.

Two kernels, chosen by :func:`variant` from the dtype, the width and the
alignment of the input alone: ``"sm90"`` (bf16, W % 8 == 0, 16-byte-aligned
input: TMA, mbarriers and wgmma) and ``"wmma"`` (fp32, and bf16 of other
widths: the wmma / FMA kernel over ``csrc/decode_conv.cuh``). A non-zero
return code raises; nothing falls back to the other kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .scse_conv import (_DTYPE_CODES, affine, check_parts, conv_affine,
                        on_cuda, padded16, tap_major)

# Where the wrapper launches a kernel, and nowhere else: the total and each
# variant's count.
launches = 0
launches_sm90 = 0
launches_wmma = 0

VARIANTS = {"wmma": 0, "sm90": 1}
_SM90_K, _SM90_N = 16, 64        # input channels per stage, outputs per pass


def variant(dtype, width: int, data_ptr: int) -> str:
    """The kernel that takes a map of ``dtype`` and ``width`` whose data
    starts at ``data_ptr``: ``"sm90"`` where the TMA can read it (bf16, rows
    of a multiple of 16 bytes, a 16-byte-aligned base), else ``"wmma"``."""
    if dtype == torch.bfloat16 and width % 8 == 0 and data_ptr % 16 == 0:
        return "sm90"
    return "wmma"


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
    """OIHW ``(cout, cin, 3, 3)`` → the sm90 kernel's B operand in bf16,
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


def conv3x3_bn_relu_reference(x, w, scale=None, bias=None,
                              relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` + affine + ReLU."""
    return conv_affine(x, w, scale, bias, relu).to(x.dtype)


def _run(lib, stream, x, w, scale, bias, relu):
    """Marshal one call of ``conv3x3_fwd`` from ``lib``, with the kernel
    :func:`variant` picks; returns (cudaError_t, output, variant)."""
    (x,), B, H, W, (C,) = check_parts("conv3x3_bn_relu", [x])
    cout = int(w.shape[0])
    if w.shape[1] != C:
        raise ValueError(f"w {tuple(w.shape)} does not match Cin={C}")
    var = variant(x.dtype, W, x.data_ptr())
    if var == "sm90":
        wt = sm90_weight_operand(w).to(x.device)
        coutP = int(wt.shape[0]) * _SM90_N
    else:
        coutP = padded16(cout)
        wt = tap_major(w, x.dtype, C, coutP)
    s, b = affine(scale, bias, cout, x.device)
    out = torch.empty((B, cout, H, W), dtype=x.dtype, device=x.device)
    rc = lib.conv3x3_fwd(_DTYPE_CODES[x.dtype], VARIANTS[var], x.data_ptr(),
                         wt.data_ptr(), s.data_ptr(), b.data_ptr(),
                         out.data_ptr(), B, H, W, C, cout, coutP, int(relu),
                         ctypes.c_void_p(stream))
    return rc, out, var


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, relu: bool = True,
                    tile_rows: Optional[int] = None) -> torch.Tensor:
    """Fused 3×3 SAME conv + per-channel affine + ReLU.

    x: (N, Cin, H, W); w: (Cout, Cin, 3, 3). ``tile_rows`` (the TPU kernel's
    row-tile knob) is accepted and ignored.
    """
    del tile_rows
    if not on_cuda("conv3x3_bn_relu", x):
        return conv3x3_bn_relu_reference(x, w, scale, bias, relu)
    global launches, launches_sm90, launches_wmma
    lib = _build.load("conv3x3")
    with torch.cuda.device(x.device):
        rc, out, var = _run(lib,
                            torch.cuda.current_stream(x.device).cuda_stream,
                            x, w, scale, bias, relu)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_relu {var} kernel failed to launch: "
                           f"CUDA error {rc} (out {tuple(out.shape)})")
    launches += 1
    if var == "sm90":
        launches_sm90 += 1
    else:
        launches_wmma += 1
    return out
