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
from .scse_conv import (_DTYPE_CODES, VARIANTS, affine, check_parts,
                        conv_affine, conv_weights, on_cuda)

# Where the wrapper launches a kernel, and nowhere else: the total and each
# variant's count.
launches = 0
launches_sm90 = 0
launches_wmma = 0


def variant(dtype, width: int, data_ptr: int) -> str:
    """The kernel that takes a map of ``dtype`` and ``width`` whose data
    starts at ``data_ptr``: ``"sm90"`` where the TMA can read it (bf16, rows
    of a multiple of 16 bytes, a 16-byte-aligned base), else ``"wmma"``."""
    if dtype == torch.bfloat16 and width % 8 == 0 and data_ptr % 16 == 0:
        return "sm90"
    return "wmma"


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
    wt, coutP = conv_weights(var, w, x.dtype, x.device)
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
    row-tile knob) is accepted and ignored. Raises under grad mode when an
    input requires grad (no backward).
    """
    del tile_rows
    _build.refuse_autograd("conv3x3_bn_relu", x, w, scale, bias)
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
