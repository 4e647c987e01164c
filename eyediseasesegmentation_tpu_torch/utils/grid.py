"""Sliding-window tiling schedule (torch port).

A copy of ``eyediseasesegmentation_tpu/utils/grid.py``, the behavioral port
of the reference ``make_grid`` (``src/main/util/base_utils.py:52-71``):
covers an H×W image with ``window``-sized tiles whose starts are evenly
spaced with at least ``min_overlap`` pixels of overlap; the final row/column
snaps to the image edge. Consumed by ``ops/tiling.py`` and
``data/patches.py``.
"""

from __future__ import annotations

import numpy as np


def make_grid(shape, window: int = 256, min_overlap: int = 32) -> np.ndarray:
    """Return tile slices of shape (N, 4); each row is [x1, x2, y1, y2]."""
    x, y = int(shape[0]), int(shape[1])

    def starts(size: int) -> np.ndarray:
        n = size // (window - min_overlap) + 1
        s = np.linspace(0, size, num=n, endpoint=False, dtype=np.int64)
        s[-1] = size - window
        return s

    x1 = starts(x)
    y1 = starts(y)
    x2 = np.clip(x1 + window, 0, x)
    y2 = np.clip(y1 + window, 0, y)
    slices = np.zeros((len(x1), len(y1), 4), dtype=np.int64)
    for i in range(len(x1)):
        for j in range(len(y1)):
            slices[i, j] = (x1[i], x2[i], y1[j], y2[j])
    return slices.reshape(-1, 4)
