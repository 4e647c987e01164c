"""GT-vs-prediction overlay (torch port).

Counterpart of ``overlay_mask_image`` in
``eyediseasesegmentation_tpu/analysis/visualize.py`` (reference
visualize.py:60-107): TP green, FN red, FP yellow, blended onto the image.
PIL is imported only to save.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def overlay_mask_image(image: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                       alpha: float = 0.5,
                       save_path: Optional[Path] = None) -> np.ndarray:
    """TP green, FN red, FP yellow over ``image`` (uint8 RGB out)."""
    g = gt > 0
    p = pred > 0
    overlay = np.zeros((*g.shape, 3), np.float32)
    overlay[g & p] = (0, 255, 0)
    overlay[g & ~p] = (255, 0, 0)
    overlay[~g & p] = (255, 255, 0)
    m = (overlay.sum(-1) > 0)[..., None].astype(np.float32)
    out = image.astype(np.float32) * (1 - alpha * m) + overlay * alpha
    out = np.clip(out, 0, 255).astype(np.uint8)
    if save_path is not None:
        from PIL import Image
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(out).save(save_path)
    return out
