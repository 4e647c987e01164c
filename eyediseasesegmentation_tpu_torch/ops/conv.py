"""3×3 conv + affine + ReLU: kernel wrapper and plain version.

Counterpart of ``eyediseasesegmentation_tpu/ops/pallas_conv.py``:
``y = relu?(scale · conv3×3_SAME(x) + bias)`` with fp32 accumulation and the
output in the input's dtype. No model calls it; it is the plain-convolution
baseline beside the gated kernels. Maps are NCHW and the weight is OIHW
``(cout, cin, 3, 3)``. A CPU tensor takes :func:`conv3x3_bn_relu_reference`;
a CUDA tensor launches the kernel in ``csrc/conv3x3.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .scse_conv import (_DTYPE_CODES, affine, check_parts, conv_affine,
                        on_cuda, padded16, tap_major)

# Where the kernel's wrapper launches it, and nowhere else.
launches = 0


def conv3x3_bn_relu_reference(x, w, scale=None, bias=None,
                              relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` + affine + ReLU."""
    return conv_affine(x, w, scale, bias, relu).to(x.dtype)


def _run(lib, stream, x, w, scale, bias, relu):
    """Marshal one call of ``conv3x3_fwd`` from ``lib``; returns
    (cudaError_t, output)."""
    (x,), B, H, W, (C,) = check_parts("conv3x3_bn_relu", [x])
    cout = int(w.shape[0])
    if w.shape[1] != C:
        raise ValueError(f"w {tuple(w.shape)} does not match Cin={C}")
    coutP = padded16(cout)
    wt = tap_major(w, x.dtype, C, coutP)
    s, b = affine(scale, bias, cout, x.device)
    out = torch.empty((B, cout, H, W), dtype=x.dtype, device=x.device)
    rc = lib.conv3x3_fwd(_DTYPE_CODES[x.dtype], x.data_ptr(), wt.data_ptr(),
                         s.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W,
                         C, cout, coutP, int(relu), ctypes.c_void_p(stream))
    return rc, out


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
    global launches
    lib = _build.load("conv3x3")
    with torch.cuda.device(x.device):
        rc, out = _run(lib, torch.cuda.current_stream(x.device).cuda_stream,
                       x, w, scale, bias, relu)
    if rc != 0:
        raise RuntimeError("conv3x3_bn_relu kernel failed to launch: CUDA "
                           f"error {rc} (out {tuple(out.shape)})")
    launches += 1
    return out
