"""Synthetic fundus-like data for tests and smoke runs (torch port).

A copy of ``eyediseasesegmentation_tpu/data/synthetic.py``: circular-FOV
images with bright blob "lesions" (or thin curvilinear "vessels") written in
the IDRiD (or processed DRIVE) directory layout, so that the whole pipeline
runs without real data. The numpy draws are the JAX package's, so a seed
gives the same arrays and the same files in both packages. PIL is imported
only to write the files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from .paths import lesion_dict


def synthetic_fundus(rng: np.random.RandomState, size: Tuple[int, int] = (128, 128),
                     n_blobs: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Return (image uint8 HWC, mask uint8 HW in {0,255}). Lesions are bright
    gaussian blobs inside a circular field of view — learnable by a small model
    in a few steps."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2, w / 2
    fov = ((yy - cy) ** 2 / (0.48 * h) ** 2 + (xx - cx) ** 2 / (0.48 * w) ** 2) < 1.0
    base = np.stack([
        120 + 30 * np.sin(xx / w * 3.1),
        60 + 20 * np.cos(yy / h * 2.7),
        30 + 10 * np.sin((xx + yy) / (h + w) * 6.2),
    ], axis=-1)
    img = base + rng.randn(h, w, 3) * 8.0
    mask = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        by = rng.uniform(0.25 * h, 0.75 * h)
        bx = rng.uniform(0.25 * w, 0.75 * w)
        r = rng.uniform(0.03, 0.08) * min(h, w)
        blob = np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * r ** 2))
        img[..., 0] += blob * 120
        img[..., 1] += blob * 110
        mask = np.maximum(mask, (blob > 0.4).astype(np.float32))
    img = np.clip(img * fov[..., None], 0, 255).astype(np.uint8)
    mask = (mask * fov * 255).astype(np.uint8)
    return img, mask


def synthetic_vessels(rng: np.random.RandomState,
                      size: Tuple[int, int] = (64, 64)
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Square fundus-like image with thin bright curvilinear 'vessels'."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([110 + 20 * np.sin(xx / w * 4),
                    55 + 15 * np.cos(yy / h * 3),
                    25 + 8 * np.sin((xx - yy) / (h + w) * 5)], axis=-1)
    mask = np.zeros((h, w), np.float32)
    for _ in range(3):
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.1, 0.3) * h
        cy = rng.uniform(0.3, 0.7) * h
        curve = cy + amp * np.sin(xx / w * np.pi * 2 + phase)
        dist = np.abs(yy - curve)
        width = rng.uniform(1.0, 2.5)
        vessel = np.exp(-(dist / width) ** 2)
        img[..., 0] += vessel * 80
        mask = np.maximum(mask, (vessel > 0.4).astype(np.float32))
    img = np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
    return img, (mask * 255).astype(np.uint8)


def make_vessel_tree(root, n_train: int = 6, n_test: int = 3,
                     size: Tuple[int, int] = (64, 64), seed: int = 1999) -> dict:
    """Write a synthetic vessel dataset in the processed DRIVE layout:
    ``root/{train,test}/{image,mask}/N.jpg`` (reference build_drive.py)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    root = Path(root)
    paths = {}
    for split, n in (("train", n_train), ("test", n_test)):
        img_dir = root / split / "image"
        msk_dir = root / split / "mask"
        img_dir.mkdir(parents=True, exist_ok=True)
        msk_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = synthetic_vessels(rng, size)
            Image.fromarray(img).save(img_dir / f"{i}.jpg", quality=95)
            Image.fromarray(mask).save(msk_dir / f"{i}.jpg", quality=95)
        paths[split] = {"image": img_dir, "mask": msk_dir}
    return paths


def make_idrid_tree(root, lesion_type: str = "EX", n_train: int = 6,
                    n_test: int = 4, size: Tuple[int, int] = (128, 128),
                    seed: int = 1999) -> dict:
    """Write a synthetic dataset in the IDRiD layout the path algebra expects:

      root/train/image/IDRiD_XX.jpg
      root/train/mask/<lesion dir>/IDRiD_XX_<LESION>.tif
      root/test/image/..., root/test/label/<lesion dir>/...
    """
    from PIL import Image

    rng = np.random.RandomState(seed)
    root = Path(root)
    lesion_dir = lesion_dict[lesion_type].dir_name
    paths = {}
    for split, n, mask_sub in (("train", n_train, "mask"), ("test", n_test, "label")):
        img_dir = root / split / "image"
        msk_dir = root / split / mask_sub / lesion_dir
        img_dir.mkdir(parents=True, exist_ok=True)
        msk_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = synthetic_fundus(rng, size)
            name = f"IDRiD_{split[:2]}{i:02d}"
            Image.fromarray(img).save(img_dir / f"{name}.jpg", quality=95)
            Image.fromarray(mask).save(msk_dir / f"{name}_{lesion_type}.tif")
        paths[split] = {"image": img_dir, "mask": msk_dir.parent}
    return paths
