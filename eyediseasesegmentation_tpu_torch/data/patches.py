"""Offline patch extraction for tile-based training (torch port).

A copy of ``eyediseasesegmentation_tpu/data/patches.py``, the behavioral
port of reference ``src/data/build_patches.py:18-89``: cover each image
with 256² windows (32 px minimum overlap, ``make_grid``), save every patch
(mask binarized at > 50), then delete random background-only patches so
that positives and negatives balance; ``build_dataframe`` writes the
``img_mask.csv`` that tile-mode training reads (train.py:77-89).

The csv goes through the standard ``csv`` module with the bytes of
``pandas.DataFrame.to_csv(index=False)``: an ``img,mask`` header, ``\\n``
line ends and minimal quoting. PIL is imported where a file is read or
written.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..utils import make_grid


def build_patches(images: Sequence[Path], mask_paths: Sequence[Path],
                  out_imgs: Path, out_mask: Path, window: int = 256,
                  min_overlap: int = 32, seed: int = 1999) -> dict:
    """Write balanced positive/negative patches; returns counts."""
    from PIL import Image

    out_imgs = Path(out_imgs)
    out_mask = Path(out_mask)
    out_imgs.mkdir(parents=True, exist_ok=True)
    out_mask.mkdir(parents=True, exist_ok=True)

    pos, neg = 0, 0
    neg_names: List[str] = []
    for img_path, mask_path in zip(images, mask_paths):
        img = np.asarray(Image.open(img_path).convert("RGB"))
        mask = np.asarray(Image.open(mask_path).convert("L"))
        mask = (mask > 50).astype(np.uint8)
        for j, (x1, x2, y1, y2) in enumerate(make_grid(img.shape[:2], window,
                                                       min_overlap)):
            name = Path(img_path).name[:-4] + f"_patch_{j}.jpg"
            Image.fromarray(img[x1:x2, y1:y2]).save(out_imgs / name,
                                                    quality=100,
                                                    subsampling=0)
            Image.fromarray(mask[x1:x2, y1:y2] * 255).save(out_mask / name,
                                                           quality=100,
                                                           subsampling=0)
            if mask[x1:x2, y1:y2].sum() > 0:
                pos += 1
            else:
                neg += 1
                neg_names.append(name)

    removed = 0
    if neg > pos:  # rebalance: drop random negatives (build_patches.py:63-83)
        rng = np.random.RandomState(seed)
        rm = rng.choice(len(neg_names), neg - pos, replace=False)
        for idx in rm:
            (out_imgs / neg_names[idx]).unlink(missing_ok=True)
            (out_mask / neg_names[idx]).unlink(missing_ok=True)
            removed += 1
    return {"pos": pos, "neg": neg, "removed": removed}


def read_img_mask_csv(csv_path: Path, root: Optional[Path] = None):
    """Read an ``img_mask.csv`` patch list back into (image_paths,
    mask_paths), the consumer of ``build_dataframe``'s output for tile-mode
    training (reference train.py:77-89). ``root``, if given, rebases
    relative paths."""
    def _p(s):
        p = Path(s)
        return (Path(root) / p) if (root is not None
                                    and not p.is_absolute()) else p

    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [_p(r["img"]) for r in rows], [_p(r["mask"]) for r in rows]


def build_dataframe(img_dir: Path, mask_dir: Path,
                    out_csv: Optional[Path] = None) -> Path:
    """Write the img/mask pairing csv (build_patches.py:85-89)."""
    img_dir = Path(img_dir)
    mask_dir = Path(mask_dir)
    imgs = sorted(img_dir / f for f in os.listdir(img_dir))
    masks = sorted(mask_dir / f for f in os.listdir(mask_dir))
    if len(imgs) != len(masks):     # a DataFrame of unequal columns raises
        raise ValueError(f"{len(imgs)} images but {len(masks)} masks")
    out_csv = out_csv or (img_dir.parent / "img_mask.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["img", "mask"])
        writer.writerows(zip(imgs, masks))
    return out_csv
