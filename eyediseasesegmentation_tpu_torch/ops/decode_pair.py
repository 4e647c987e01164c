"""The decode node's two convs as one kernel: wrapper and plain version.

Counterpart of ``eyediseasesegmentation_tpu/ops/pallas_decode_pair.py``:

    y1 = relu?(scale1 · conv3×3(cat(parts) · scse_gate) + bias1)
    y2 = relu?(scale2 · conv3×3(y1) + bias2)
    csum[b, c] = Σ_hw y2[b, c]                    (fp32, before y2's rounding)

``y1`` is rounded to the parts' dtype between the convs; the second conv
pads it with zeros. With ``up_part0`` part 0 is the W-upsampled half-height
map (``upsample2x_w``) and the H direction of the bilinear ×2 is taken
inside: even rows 0.25·r[m−1] + 0.75·r[m], odd rows 0.75·r[m] +
0.25·r[m+1], clamped at the edges, rounded to the dtype. Maps are NCHW, weights OIHW; names and argument
order follow the JAX function. CPU parts take
:func:`scse_conv3x3_pair_reference`; CUDA parts launch the kernels in
``csrc/decode_pair.cu`` or raise. The kernels sum ``csum`` in a fixed order
(per-tile partial sums, then the tiles in order), so it is the same from run
to run; against the plain version it differs by fp32 reassociation (1e-4 of
its largest value is the tolerance of the GPU checks).

Two variants, chosen by :func:`variant` (that of ``ops/scse_conv.py``) from
the dtype, the width, the alignment and the channel counts of the parts
alone: ``"sm90"`` (bf16, W % 8 == 0, 16-byte-aligned parts, every part a
multiple of 16 channels) runs the TMA + wgmma convolution twice, y1 going
through a bf16 scratch map in device memory; ``"wmma"`` (fp32, and bf16 of
other shapes) is one kernel that keeps y1 in shared memory up to cout 64,
and beyond runs the wmma stage kernel twice with y1 in a scratch map in
device memory. A non-zero return code raises; nothing falls back to the
other variant.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .scse_conv import (_DTYPE_CODES, _F32, VARIANTS, affine, check_parts,
                        conv_affine, conv_weights, gate_map_scratch,
                        gate_operands, gated_concat, on_cuda, part_arrays,
                        tap_major, variant)

# Where the wrapper launches the kernels, and nowhere else: the total and
# each variant's count (one per call).
launches = 0
launches_sm90 = 0
launches_wmma = 0

_Y1_RESIDENT = 64   # y1 channels the wmma kernel keeps in shared memory


def upsample2x_h(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 along H only (half-pixel centres, edge clamp), computed in
    fp32 and rounded to ``x.dtype``."""
    y = F.interpolate(x.to(_F32), scale_factor=(2, 1), mode="bilinear",
                      align_corners=False)
    return y.to(x.dtype)


def scse_conv3x3_pair_reference(parts, gate_c, sse_kernel, sse_bias, k1,
                                scale1, bias1, k2, scale2, bias2,
                                relu: bool = True, gated: bool = True,
                                up_part0: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: cat + gate + two ``F.conv2d`` stages."""
    parts = list(parts)
    if up_part0:
        parts = [upsample2x_h(parts[0])] + parts[1:]
    x = gated_concat(parts, gate_c, sse_kernel, sse_bias, gated)
    y1 = conv_affine(x, k1, scale1, bias1, relu).to(x.dtype)
    y2 = conv_affine(y1, k2, scale2, bias2, relu)
    return y2.to(x.dtype), y2.sum((2, 3))


def _run(lib, stream, parts, gate_c, sse_kernel, sse_bias, k1, scale1, bias1,
         k2, scale2, bias2, relu, gated, up_part0):
    """Marshal one call of ``decode_pair_fwd`` from ``lib``, with the
    kernels :func:`variant` picks; returns (cudaError_t, y2, csum,
    variant)."""
    parts, B, H, W, channels = check_parts("scse_conv3x3_pair", parts,
                                           up_part0)
    dtype, dev = parts[0].dtype, parts[0].device
    C, cout = sum(channels), int(k1.shape[0])
    if k1.shape[1] != C or tuple(k2.shape[:2]) != (cout, cout):
        raise ValueError(f"k1 {tuple(k1.shape)} / k2 {tuple(k2.shape)} do not "
                         f"match ΣC={C}, cout={cout}")
    var = variant(dtype, W, [p.data_ptr() for p in parts], channels)
    gc, wsse, bsse = gate_operands(gate_c, sse_kernel, sse_bias, B, C, dev)
    w1, coutP = conv_weights(var, k1, dtype, dev)
    wide = var == "wmma" and coutP > _Y1_RESIDENT   # y1 in device memory
    if var == "sm90":
        w2 = conv_weights(var, k2, dtype, dev)[0]
    else:
        w2 = tap_major(k2, dtype, cout if wide else coutP, coutP)
    y1 = (torch.empty((B, cout, H, W), dtype=dtype, device=dev)
          if var == "sm90" or wide else None)
    s1, b1 = affine(scale1, bias1, cout, dev)
    s2, b2 = affine(scale2, bias2, cout, dev)
    y2 = torch.empty((B, cout, H, W), dtype=dtype, device=dev)
    csum = torch.empty((B, cout), dtype=_F32, device=dev)
    partial = torch.empty(
        (B, lib.decode_pair_tiles(VARIANTS[var], H, W), cout), dtype=_F32,
        device=dev)
    gmap, gmap_ptr = gate_map_scratch(gated, B, H, W, dev)
    ptrs, chs = part_arrays(parts, channels)
    rc = lib.decode_pair_fwd(
        _DTYPE_CODES[dtype], VARIANTS[var], len(parts), ptrs, chs,
        int(up_part0), gc.data_ptr(), wsse.data_ptr(), bsse.data_ptr(),
        gmap_ptr, w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), None if y1 is None else y1.data_ptr(),
        y2.data_ptr(), partial.data_ptr(), csum.data_ptr(), B, H, W, cout,
        coutP, int(relu), int(gated), ctypes.c_void_p(stream))
    del gmap, partial, y1   # alive until the launches were enqueued
    return rc, y2, csum, var


def scse_conv3x3_pair(parts: Sequence[torch.Tensor], gate_c, sse_kernel,
                      sse_bias, k1, scale1: Optional[torch.Tensor],
                      bias1: Optional[torch.Tensor], k2,
                      scale2: Optional[torch.Tensor],
                      bias2: Optional[torch.Tensor], relu: bool = True,
                      gated: bool = True, tile_rows: Optional[int] = None,
                      up_part0: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decode-node conv stack + channel-sum epilogue (see module doc).

    parts: (B, c_i, H, W) maps of one dtype; with ``up_part0`` part 0 is
    (B, c_0, H/2, W). gate_c: (B, ΣC) fp32, already sigmoided; sse_kernel:
    (ΣC,); sse_bias: scalar. k1: (cout, ΣC, 3, 3); k2: (cout, cout, 3, 3);
    scale*/bias*: (cout,) folded BN (None = identity). ``tile_rows`` (the
    TPU kernel's row-tile knob) is accepted and ignored.

    Returns ``(y2, csum)``: y2 (B, cout, H, W) in the parts' dtype, csum
    (B, cout) fp32 = Σ_hw y2. Raises under grad mode when an input
    requires grad (no backward).
    """
    del tile_rows
    parts = list(parts)
    _build.refuse_autograd("scse_conv3x3_pair", parts, gate_c, sse_kernel,
                           sse_bias, k1, scale1, bias1, k2, scale2, bias2)
    if not on_cuda("scse_conv3x3_pair", parts[0]):
        return scse_conv3x3_pair_reference(
            parts, gate_c, sse_kernel, sse_bias, k1, scale1, bias1, k2,
            scale2, bias2, relu, gated, up_part0)
    global launches, launches_sm90, launches_wmma
    lib = _build.load("decode_pair")
    dev = parts[0].device
    with torch.cuda.device(dev):
        rc, y2, csum, var = _run(
            lib, torch.cuda.current_stream(dev).cuda_stream, parts, gate_c,
            sse_kernel, sse_bias, k1, scale1, bias1, k2, scale2, bias2, relu,
            gated, up_part0)
    if rc != 0:
        raise RuntimeError(f"scse_conv3x3_pair {var} kernels failed to "
                           f"launch: CUDA error {rc} (out {tuple(y2.shape)})")
    launches += 1
    if var == "sm90":
        launches_sm90 += 1
    else:
        launches_wmma += 1
    return y2, csum
