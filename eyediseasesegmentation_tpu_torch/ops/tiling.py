"""Sliding-window (tiled) inference (torch port).

Counterpart of ``eyediseasesegmentation_tpu/ops/tiling.py``'s
``tiled_predict``: over a static ``make_grid`` schedule, each tile is sliced
from the full-resolution image, resized to the model's scale, predicted,
resized back to the window and pasted into a canvas on the image's device.
Overlaps follow the reference (later tiles overwrite, tta.py:213);
``blend='mean'`` averages them instead. ``tiled_predict_sharded`` splits
the grid over the ranks of a mesh (``parallel.mesh``) and combines their
canvases with collectives, to the same map.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import mesh as P


def resize_antialiased(img: torch.Tensor, out_hw) -> torch.Tensor:
    """(H, W) or (H, W, C) → ``out_hw``: bilinear at half-pixel centres with
    the antialias prefilter on a downscale, as ``jax.image.resize(...,
    "linear")`` with its default ``antialias=True`` (the whole-image path's
    ``ops.image.resize`` has no prefilter)."""
    if tuple(img.shape[:2]) == tuple(out_hw):
        return img
    x = img[None, None] if img.ndim == 2 else img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0, 0] if img.ndim == 2 else y[0].permute(1, 2, 0)


def _check_blend(blend: str) -> None:
    if blend not in ("overwrite", "mean"):
        raise ValueError(f"blend must be 'overwrite' or 'mean', not {blend!r}")


def _tile(predict_fn, image, x1, y1, window: int, scale_size: int):
    """(the window's slices, its probabilities at window size): the tile
    cut at a start clamped into the image, resized to the model's scale,
    predicted and resized back."""
    h, w = image.shape[0], image.shape[1]
    x1 = min(max(int(x1), 0), h - window)
    y1 = min(max(int(y1), 0), w - window)
    win = (slice(x1, x1 + window), slice(y1, y1 + window))
    tile = resize_antialiased(image[win], (scale_size, scale_size))
    return win, resize_antialiased(predict_fn(tile).to(torch.float32),
                                   (window, window))


def tiled_predict(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                  image: torch.Tensor, grid, window: int, scale_size: int,
                  blend: str = "overwrite") -> torch.Tensor:
    """Predict a full-resolution probability map tile by tile.

    Args:
      predict_fn: maps a (scale_size, scale_size, C) fp32 tile to
        (scale_size, scale_size) probabilities.
      image: (H, W, C) full-resolution input on the model's device; the
        uint8 wire is cast there.
      grid: (N, 4) [x1, x2, y1, y2] rows from ``utils.make_grid``. A start is
        clamped so that its ``window`` fits in the image, as
        ``lax.dynamic_slice`` clamps it in the JAX package.
      window: tile size in image pixels.
      scale_size: model input size.
      blend: 'overwrite' (reference semantics) or 'mean'.

    Returns (H, W) fp32 probabilities on the image's device.
    """
    _check_blend(blend)
    image = image.to(torch.float32)
    h, w = image.shape[0], image.shape[1]
    canvas = image.new_zeros((h, w))
    weight = image.new_zeros((h, w)) if blend == "mean" else None
    for x1, _, y1, _ in np.asarray(grid).tolist():
        win, probs = _tile(predict_fn, image, x1, y1, window, scale_size)
        if weight is None:
            canvas[win] = probs
        else:
            canvas[win] += probs
            weight[win] += 1.0
    if weight is not None:
        canvas = canvas / weight.clamp_min(1.0)
    return canvas


def tiled_predict_sharded(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                          image: torch.Tensor, grid, window: int,
                          scale_size: int, mesh: P.Mesh,
                          blend: str = "overwrite") -> torch.Tensor:
    """:func:`tiled_predict` with the grid split over ``mesh``'s data axis:
    each rank predicts a contiguous block of tiles against its copy of the
    image and the ranks' canvases are combined, so every rank returns the
    whole map, equal to the sequential one.

    The grid is padded to a multiple of the ranks with repeats of tile 0
    at priority −1, which write nothing. Each tile writes its global grid
    index as the priority of its pixels; ``overwrite`` keeps, per pixel,
    the value of the covering tile of highest priority (a ``pmax`` of the
    priorities, then a ``psum`` of the canvas where this rank holds it),
    which is exactly "the last tile wins". ``mean`` is a ``psum`` of canvas
    and weight."""
    _check_blend(blend)
    image = image.to(torch.float32)
    h, w = image.shape[0], image.shape[1]
    grid = np.asarray(grid)
    n = mesh.axis_size()
    g = len(grid)
    g_pad = -(-g // n) * n
    rows = P.batch_rows(mesh, g_pad)
    canvas = image.new_zeros((h, w))
    if blend == "overwrite":
        prio = image.new_full((h, w), -2.0)
    else:
        weight = image.new_zeros((h, w))
    for i in range(rows.start, rows.stop):
        if i >= g:                     # padding: priority −1, no write
            continue
        x1, _, y1, _ = grid[i].tolist()
        win, probs = _tile(predict_fn, image, x1, y1, window, scale_size)
        if blend == "overwrite":
            canvas[win] = probs        # a rank's tiles rise in priority
            prio[win] = float(i)
        else:
            canvas[win] += probs
            weight[win] += 1.0
    if blend == "overwrite":
        best = P.pmax(prio, mesh)
        mine = (prio == best) & (prio >= 0)
        return P.psum(torch.where(mine, canvas, torch.zeros_like(canvas)),
                      mesh)
    both = P.psum(torch.stack([canvas, weight]), mesh)
    return both[0] / both[1].clamp_min(1.0)
