"""Prediction visualisation overlays (torch port).

Counterpart of ``eyediseasesegmentation_tpu/analysis/visualize.py``
(reference ``src/visualization/visualize.py``): blend image+mask
(``overlay_image_mask``), the TP(green)/FN(red)/FP(yellow) GT-vs-prediction
comparison (``overlay_mask_image``, l.60-107), the image|mask panel
(``show_examples``) and the grid of augmented samples
(``visualize_augmentations``), which draws the port's transform with the
port's generators, so its panels are not the JAX package's. PIL is
imported only to save.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch


def overlay_image_mask(image: np.ndarray, mask: np.ndarray,
                       color=(0, 255, 0), alpha: float = 0.5) -> np.ndarray:
    """Blend a binary mask onto an RGB image."""
    out = image.astype(np.float32).copy()
    m = (mask > 0).astype(np.float32)[..., None]
    out = out * (1 - alpha * m) + np.asarray(color, np.float32) * alpha * m
    return np.clip(out, 0, 255).astype(np.uint8)


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


def visualize_augmentations(image: np.ndarray, mask: np.ndarray,
                            transform, out_path: Path, n: int = 9,
                            seed: int = 0) -> Path:
    """Render an n-panel grid of augmented (image|mask) samples, the visual
    smoke check of an augmentation policy (reference src/data/test.py:46-67
    writes test.jpg): ``transform.train(img, mask, rng)`` of the port's
    ``data.transforms`` on the CPU, sample ``i`` from ``fold_in(seed, i)``."""
    from PIL import Image

    from ..data.transforms import AugRng
    from ..utils.seeding import fold_in

    cols = int(np.ceil(np.sqrt(n)))
    root = torch.Generator().manual_seed(seed)
    img_t = torch.as_tensor(np.asarray(image, np.float32))
    mask_t = torch.as_tensor(np.asarray(mask, np.float32))
    panels = []
    for i in range(n):
        img_a, mask_a = transform.train(img_t, mask_t,
                                        AugRng(fold_in(root, i)))
        img_np = img_a.numpy()
        img_np = (img_np - img_np.min()) / max(img_np.max() - img_np.min(),
                                               1e-6)
        panels.append(overlay_image_mask((img_np * 255).astype(np.uint8),
                                         mask_a.numpy()))
    h, w = panels[0].shape[:2]
    grid = np.zeros((cols * h, cols * w, 3), np.uint8)
    for i, p in enumerate(panels):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = p
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(out_path)
    return out_path


def show_examples(name: str, image: np.ndarray, mask: np.ndarray,
                  out_dir: Path) -> Path:
    """Save an image|mask side-by-side panel (reference show_examples)."""
    from PIL import Image

    m = (np.stack([mask] * 3, -1) * 255).astype(np.uint8) if mask.ndim == 2 else mask
    panel = np.concatenate([image.astype(np.uint8), m.astype(np.uint8)], axis=1)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.jpg"
    Image.fromarray(panel).save(path)
    return path
