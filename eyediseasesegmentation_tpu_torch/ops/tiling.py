"""Sliding-window (tiled) inference (torch port).

Counterpart of ``eyediseasesegmentation_tpu/ops/tiling.py``'s
``tiled_predict``: over a static ``make_grid`` schedule, each tile is sliced
from the full-resolution image, resized to the model's scale, predicted,
resized back to the window and pasted into a canvas on the image's device.
Overlaps follow the reference (later tiles overwrite, tta.py:213);
``blend='mean'`` averages them instead. The JAX package's multi-chip
``tiled_predict_sharded`` is not ported yet (ROADMAP.md, multi-GPU).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


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
    if blend not in ("overwrite", "mean"):
        raise ValueError(f"blend must be 'overwrite' or 'mean', not {blend!r}")
    image = image.to(torch.float32)
    h, w = image.shape[0], image.shape[1]
    canvas = image.new_zeros((h, w))
    weight = image.new_zeros((h, w)) if blend == "mean" else None
    for x1, _, y1, _ in np.asarray(grid).tolist():
        x1 = min(max(int(x1), 0), h - window)
        y1 = min(max(int(y1), 0), w - window)
        win = (slice(x1, x1 + window), slice(y1, y1 + window))
        tile = resize_antialiased(image[win], (scale_size, scale_size))
        probs = resize_antialiased(predict_fn(tile).to(torch.float32),
                                   (window, window))
        if weight is None:
            canvas[win] = probs
        else:
            canvas[win] += probs
            weight[win] += 1.0
    if weight is not None:
        canvas = canvas / weight.clamp_min(1.0)
    return canvas
