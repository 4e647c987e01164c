"""Offline augmentation suite for the vessel datasets (torch port).

A copy of ``eyediseasesegmentation_tpu/data/augment_offline.py``: capability
parity with reference ``src/data/augment_vessel/`` (augment_data.py,
methods.py, pad_img.py), expanding small vessel datasets (DRIVE/CHASEDB1) on
disk before patch extraction with PIL/numpy ops, and the pad-to-square
preprocessing. The same seeds give the same files as the JAX package in one
process: an op's seed takes ``hash(op) % 997``, as there, and Python salts
string hashes per process unless ``PYTHONHASHSEED`` is set. PIL is imported
inside the functions that use it.
"""

from __future__ import annotations

import concurrent.futures
import io
from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# single-image ops (reference methods.py:224-523)
# ---------------------------------------------------------------------------

def random_rotation(img, mask, rng, max_deg=30):
    from PIL import Image

    deg = float(rng.uniform(-max_deg, max_deg))
    return (img.rotate(deg, resample=Image.BILINEAR),
            mask.rotate(deg, resample=Image.NEAREST))


def random_color(img, mask, rng):
    """Color/contrast/brightness/sharpness jitter (methods.py randomColor)."""
    from PIL import ImageEnhance

    out = img
    for enh in (ImageEnhance.Color, ImageEnhance.Brightness,
                ImageEnhance.Contrast, ImageEnhance.Sharpness):
        out = enh(out).enhance(float(rng.uniform(0.7, 1.3)))
    return out, mask


def random_gaussian(img, mask, rng, sigma_max=2.0):
    from PIL import ImageFilter

    return (img.filter(ImageFilter.GaussianBlur(float(rng.uniform(0.3, sigma_max)))),
            mask)


def random_flip(img, mask, rng):
    from PIL import Image

    if rng.rand() < 0.5:
        return (img.transpose(Image.FLIP_LEFT_RIGHT),
                mask.transpose(Image.FLIP_LEFT_RIGHT))
    return (img.transpose(Image.FLIP_TOP_BOTTOM),
            mask.transpose(Image.FLIP_TOP_BOTTOM))


def jpeg_compression(img, mask, rng):
    from PIL import Image

    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=int(rng.uniform(40, 90)))
    buf.seek(0)
    return Image.open(buf).convert("RGB"), mask


def _affine(img, mask, matrix):
    from PIL import Image

    return (img.transform(img.size, Image.AFFINE, matrix, resample=Image.BILINEAR),
            mask.transform(mask.size, Image.AFFINE, matrix, resample=Image.NEAREST))


def shift_x(img, mask, rng, frac=0.1):
    dx = float(rng.uniform(-frac, frac)) * img.size[0]
    return _affine(img, mask, (1, 0, dx, 0, 1, 0))


def shift_y(img, mask, rng, frac=0.1):
    dy = float(rng.uniform(-frac, frac)) * img.size[1]
    return _affine(img, mask, (1, 0, 0, 0, 1, dy))


def shear_x(img, mask, rng, max_shear=0.2):
    s = float(rng.uniform(-max_shear, max_shear))
    return _affine(img, mask, (1, s, 0, 0, 1, 0))


def shear_y(img, mask, rng, max_shear=0.2):
    s = float(rng.uniform(-max_shear, max_shear))
    return _affine(img, mask, (1, 0, 0, s, 1, 0))


def zoom(img, mask, rng, lo=0.8, hi=1.2):
    z = float(rng.uniform(lo, hi))
    w, h = img.size
    cx, cy = w / 2, h / 2
    matrix = (1 / z, 0, cx - cx / z, 0, 1 / z, cy - cy / z)
    return _affine(img, mask, matrix)


AUGMENT_OPS: Dict[str, Callable] = {
    "rotation": random_rotation,
    "color": random_color,
    "gaussian": random_gaussian,
    "flip": random_flip,
    "jpeg": jpeg_compression,
    "shift_x": shift_x,
    "shift_y": shift_y,
    "shear_x": shear_x,
    "shear_y": shear_y,
    "zoom": zoom,
}


# ---------------------------------------------------------------------------
# orchestration (reference augment_data.py:122-221 thread-per-op, x3 per op)
# ---------------------------------------------------------------------------

def augment_dataset(img_dir: Path, mask_dir: Path, out_img_dir: Path,
                    out_mask_dir: Path,
                    ops: Sequence[str] = ("rotation", "color", "gaussian", "flip"),
                    copies_per_op: int = 3, seed: int = 1999,
                    max_workers: int = 8) -> int:
    """Write ``copies_per_op`` augmented variants per op per image; returns the
    number of files written. Thread pool mirrors the reference's threadOPS."""
    from PIL import Image

    out_img_dir = Path(out_img_dir)
    out_mask_dir = Path(out_mask_dir)
    out_img_dir.mkdir(parents=True, exist_ok=True)
    out_mask_dir.mkdir(parents=True, exist_ok=True)
    img_paths = sorted(Path(img_dir).glob("*"))
    mask_paths = sorted(Path(mask_dir).glob("*"))
    jobs = []
    for i, (ip, mp) in enumerate(zip(img_paths, mask_paths)):
        for op in ops:
            for k in range(copies_per_op):
                jobs.append((i, ip, mp, op, k))

    def run(job):
        i, ip, mp, op, k = job
        rng = np.random.RandomState(seed + i * 1000 + hash(op) % 997 + k)
        img = Image.open(ip).convert("RGB")
        mask = Image.open(mp).convert("L")
        aug_img, aug_mask = AUGMENT_OPS[op](img, mask, rng)
        name = f"{ip.stem}_{op}{k}.jpg"
        aug_img.save(out_img_dir / name, quality=100, subsampling=0)
        aug_mask.save(out_mask_dir / name, quality=100, subsampling=0)
        return name

    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(run, jobs))
    return len(results)


# ---------------------------------------------------------------------------
# pad to square (reference pad_img.py:8-35)
# ---------------------------------------------------------------------------

def pad_to_square(img: np.ndarray, size: int, is_mask: bool = False) -> np.ndarray:
    """Center-pad to size×size; masks re-thresholded at >50 (pad_img.py:8-35)."""
    h, w = img.shape[:2]
    top = (size - h) // 2
    left = (size - w) // 2
    widths = [(top, size - h - top), (left, size - w - left)]
    if img.ndim == 3:
        widths.append((0, 0))
    out = np.pad(img, widths)
    if is_mask:
        out = ((out > 50) * 255).astype(np.uint8)
    return out


def pad_dataset(img_dir: Path, out_dir: Path, size: int,
                is_mask: bool = False) -> int:
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(Path(img_dir).glob("*")):
        arr = np.asarray(Image.open(p).convert("L" if is_mask else "RGB"))
        Image.fromarray(pad_to_square(arr, size, is_mask)).save(
            out_dir / p.name, quality=100, subsampling=0)
        n += 1
    return n
