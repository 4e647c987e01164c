"""Operations and bytes of one call of the port's hand-written kernels,
from the shapes of the call's arguments.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; the work is what these inputs need (an axial sequence
padded inside the kernel counts at its own length).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _elem(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def k1_work(x_q: torch.Tensor, x_v: torch.Tensor, w_v, heads: int,
            dkq: int, dv: int, dtype) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused eval axial attention: the q/k(/v)
    projections and the five attention products (q·r_q, k·r_k, q·k,
    attn·v, attn·r_v); inputs, weights, the r tables (r_q and r_k in
    float32) and the output once."""
    b, L, cq = x_q.shape
    cross = w_v is not None
    cv = x_v.shape[2] if cross else 0
    nkq = heads * (2 * dkq + (0 if cross else dv))
    nv = heads * dv
    flops = 2 * b * L * cq * nkq + (2 * b * L * cv * nv if cross else 0)
    flops += 2 * b * heads * L * L * (3 * dkq + 2 * dv)
    elems = (b * L * cq + (b * L * cv if cross else 0) + cq * nkq
             + (cv * nv if cross else 0) + b * L * nv + dv * L * L)
    return float(flops), float(_elem(dtype) * elems + 4 * 2 * dkq * L * L)


def k2_work(parts: Sequence[torch.Tensor], cout: int, up_part0: bool,
            dtype) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode-pair call: the gated first 3×3 conv
    over the parts' concat (the gate's logit and product, 3 per input
    value), the second 3×3 conv; the parts (part 0 at half height with
    ``up_part0``), both weights and the channel gates read once, the output
    and its channel sums written once."""
    b = parts[0].shape[0]
    h, w = parts[0].shape[2], parts[0].shape[3]
    if up_part0:
        h = 2 * h
    C, px = sum(p.shape[1] for p in parts), b * h * w
    flops = (2 * 9 * C * cout + 3 * C) * px + 2 * 9 * cout * cout * px
    in_elems = sum(p.numel() for p in parts)
    nbytes = (_elem(dtype) * (in_elems + 9 * C * cout + px * cout
                              + 9 * cout * cout)
              + 4 * b * C + 4 * b * cout)
    return float(flops), float(nbytes)
