"""Spatial (context-parallel) sharding: image rows over the ranks, halos
exchanged between them (torch port, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/parallel/spatial.py``. An
activation is split along H into equal contiguous blocks, rank r holding
rows ``[r·h, (r+1)·h)``; a 3×3 conv or a ×2 upsample needs one row of each
neighbour, which :func:`halo_exchange` brings (``mesh.neighbour_rows``: one
SUM ``all_reduce`` of the edge rows; zero rows at the global edges, as the
SAME conv's padding). Every primitive equals its unsharded op on the
gathered image, and is differentiable.

* ``halo_exchange``      — this block with ``halo`` neighbour rows each side
* ``conv3x3_spatial``    — SAME 3×3 conv of an H-sharded block
* ``pool2x_spatial``     — 2×2 stride-2 max / avg pool (even local rows, so
                           no window straddles two ranks)
* ``upsample2x_spatial`` — bilinear ×2 at half-pixel centres; the edge
                           clamp is re-applied only on the ranks that own
                           the global first and last row

``spatial_predict`` runs a function of these over this rank's H-block.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .mesh import DATA_AXIS, Mesh, all_gather, batch_rows, neighbour_rows


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh,
                  axis: str = DATA_AXIS, dim: int = 2) -> torch.Tensor:
    """The local block (e.g. (B, C, h, W), ``dim`` the sharded one) with
    ``halo`` rows of each neighbour appended, h + 2·halo rows; zero rows at
    the outer edge of the first and last rank (the global image's zero
    padding)."""
    top, bottom = neighbour_rows(x, halo, mesh, dim, axis)
    return torch.cat([top, x, bottom], dim)


def conv3x3_spatial(x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                    bias=None, axis: str = DATA_AXIS,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3×3 SAME conv (OIHW ``weight``) of an H-sharded (B, C, h, W) block:
    a 1-row halo, then VALID over rows and zero-padded over columns. Equals
    the unsharded SAME conv's rows of this rank."""
    xh = halo_exchange(x, 1, mesh, axis)
    b = None if bias is None else bias.to(dtype)
    return F.conv2d(xh.to(dtype), weight.to(dtype), b, 1, (0, 1))


def pool2x_spatial(x: torch.Tensor, kind: str = "max") -> torch.Tensor:
    """2×2 stride-2 pooling of a block with an even number of local rows
    (global H divisible by 2 × ranks): no window straddles two ranks."""
    if x.shape[2] % 2:
        raise ValueError(f"pool2x_spatial: {x.shape[2]} local rows, not even")
    if kind == "max":
        return F.max_pool2d(x, 2)
    return F.avg_pool2d(x, 2)


def _clamped_halo(x: torch.Tensor, mesh: Mesh,
                  axis: str = DATA_AXIS) -> torch.Tensor:
    """The block with one neighbour row each side, the global first and
    last row repeated where there is no neighbour (the edge clamp of a
    bilinear resize)."""
    top, bottom = neighbour_rows(x, 1, mesh, 2, axis)
    if mesh.axis_index(axis) == 0:
        top = x[:, :, :1]
    if mesh.axis_index(axis) == mesh.axis_size(axis) - 1:
        bottom = x[:, :, -1:]
    return torch.cat([top, x, bottom], 2)


def upsample2x_spatial(x: torch.Tensor, mesh: Mesh,
                       axis: str = DATA_AXIS) -> torch.Tensor:
    """Bilinear ×2 (half-pixel centres, edge clamp) of an H-sharded block:
    the ×2 of the block with its clamped halo, the four rows that the halo
    itself gives dropped."""
    y = F.interpolate(_clamped_halo(x, mesh, axis), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y[:, :, 2:-2]


def spatial_predict(fn: Callable[[torch.Tensor], torch.Tensor],
                    image: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                    gather: bool = False) -> torch.Tensor:
    """``fn`` (built from the primitives above) on this rank's H-block of
    ``image`` (B, C, H, W, the same on every rank; H divisible by the
    ranks), which never sees another rank's rows but through its halos.
    Returns this rank's block of the output, or with ``gather`` the whole
    output on every rank."""
    y = fn(image[:, :, batch_rows(mesh, image.shape[2], axis)])
    return all_gather(y, mesh, dim=2, axis=axis) if gather else y
