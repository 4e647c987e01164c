"""Raw-dataset converters and offline ETL utilities (torch port).

A copy of ``eyediseasesegmentation_tpu/data/builders.py``, the host-side
(offline) equivalents of the reference's L1 data-build scripts (SURVEY.md
§2.4): ``build_vessel_dataset`` (build_drive.py / build_chasedb.py /
build_hrf.py — convert raw images+masks to ``data/processed/<DS>/{train,test}/
{image,mask}`` jpgs with the 80/20 seed-1999 split), ``compute_mean_std``
(mean_std.py), ``build_black_masks`` (blackmask.py FOV masks),
``make_multilesion`` (make_multilesion.py fused multiclass masks),
``prepare_clahe_images`` (preprocess_gan.py CLAHE on the LAB L-channel) and
``build_fgadr_dataset``. Same files and arrays as the JAX package for the
same inputs; PIL and cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# per-lesion grayscale codes of the fused multiclass mask
# (reference make_multilesion.py:21)
MULTILESION_COLORS = {"MA": 1, "HE": 10, "EX": 20, "SE": 30}


def build_vessel_dataset(source_images: Sequence[Path],
                         source_masks: Sequence[Path],
                         dest_dir: Path, split: float = 0.8,
                         seed: int = 1999) -> Dict[str, int]:
    """Convert a raw vessel dataset into the processed layout.

    Mirrors build_chasedb.py:22-24 / build_hrf.py:22-24: deterministic
    seed-1999 shuffle, first 80% train; images re-encoded as q100 jpgs with
    sequential names (build_drive.py:20-32 handles .gif masks via PIL, which
    Image.open covers transparently).
    """
    from PIL import Image

    dest_dir = Path(dest_dir)
    n = len(source_images)
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    n_train = int(round(n * split))
    counts = {"train": 0, "test": 0}
    for rank, idx in enumerate(order):
        part = "train" if rank < n_train else "test"
        img_dir = dest_dir / part / "image"
        mask_dir = dest_dir / part / "mask"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        name = f"{counts[part]}.jpg"
        Image.open(source_images[idx]).convert("RGB").save(
            img_dir / name, quality=100, subsampling=0)
        Image.open(source_masks[idx]).convert("L").save(
            mask_dir / name, quality=100, subsampling=0)
        counts[part] += 1
    return counts


def compute_mean_std(image_paths: Sequence[Path],
                     out_txt: Optional[Path] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over a dataset in [0,1] (reference mean_std.py:15-34
    — produced the DATASET_STATS constants)."""
    from PIL import Image

    s = np.zeros(3)
    sq = np.zeros(3)
    count = 0
    for p in image_paths:
        x = np.asarray(Image.open(p).convert("RGB"), dtype=np.float64) / 255.0
        s += x.sum(axis=(0, 1))
        sq += (x ** 2).sum(axis=(0, 1))
        count += x.shape[0] * x.shape[1]
    mean = s / count
    std = np.sqrt(sq / count - mean ** 2)
    if out_txt is not None:
        Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
        Path(out_txt).write_text(f"mean: {mean.tolist()}\nstd: {std.tolist()}\n")
    return mean, std


def build_black_mask(image: np.ndarray, threshold: int = 15) -> np.ndarray:
    """Retina field-of-view mask: gray > threshold, largest filled contour
    (reference blackmask.py:20-33). Returns uint8 {0,255}."""
    import cv2

    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    _, binary = cv2.threshold(gray, threshold, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    mask = np.zeros_like(gray)
    if contours:
        biggest = max(contours, key=cv2.contourArea)
        cv2.drawContours(mask, [biggest], -1, 255, thickness=cv2.FILLED)
    return mask


def build_black_masks(image_paths: Sequence[Path], out_dir: Path) -> List[Path]:
    """Write ``<name>_MASK.tif`` FOV masks (blackmask.py:20-33)."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for p in image_paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        mask = build_black_mask(img)
        out = out_dir / (Path(p).stem + "_MASK.tif")
        Image.fromarray(mask).save(out)
        outs.append(out)
    return outs


def make_multilesion(mask_dirs: Dict[str, Path], image_names: Sequence[str],
                     out_dir: Path) -> List[Path]:
    """Fuse the 4 per-lesion binary masks into one multiclass tif with the
    grayscale codes {MA:1, HE:10, EX:20, SE:30} (make_multilesion.py:21,55-60).
    Later lesions overwrite earlier ones on overlap, matching the reference's
    sequential paste order."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for name in image_names:
        fused = None
        for lesion, code in MULTILESION_COLORS.items():
            path = Path(mask_dirs[lesion]) / f"{name}_{lesion}.tif"
            if not path.exists():
                continue
            m = np.asarray(Image.open(path).convert("L"))
            m = (m > 50).astype(np.uint8)
            if fused is None:
                fused = np.zeros_like(m)
            fused[m > 0] = code
        if fused is not None:
            out = out_dir / f"{name}.tif"
            Image.fromarray(fused).save(out)
            outs.append(out)
    return outs


def clahe_gridsize(image: np.ndarray, fov_mask: Optional[np.ndarray] = None,
                   denoise: bool = False, clip_limit: float = 2.0,
                   grid_size: int = 8,
                   brightness_target: Optional[float] = None) -> np.ndarray:
    """CLAHE on the LAB L-channel with FOV-aware brightness balancing
    (reference preprocess_gan.py:18-57)."""
    import cv2

    img = image.copy()
    if brightness_target is not None and fov_mask is not None:
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        inside = fov_mask > 0
        cur = gray[inside].mean() if inside.any() else gray.mean()
        if cur > 0:
            img = np.clip(img.astype(np.float64) * (brightness_target / cur),
                          0, 255).astype(np.uint8)
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=clip_limit,
                            tileGridSize=(grid_size, grid_size))
    lab[..., 0] = clahe.apply(lab[..., 0])
    out = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    if denoise:
        out = cv2.fastNlMeansDenoisingColored(out, None, 10, 10, 1, 3)
    return out


def prepare_clahe_images(image_paths: Sequence[Path], out_dir: Path,
                         fov_masks: Optional[Sequence[Path]] = None,
                         denoise: bool = False) -> List[Path]:
    """Write CLAHE-enhanced copies to ``Images_CLAHE/`` layout
    (preprocess_gan.py:59-92); brightness balanced to the dataset mean."""
    from PIL import Image

    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # dataset mean brightness inside FOV
    brightness = []
    for i, p in enumerate(image_paths):
        img = np.asarray(Image.open(p).convert("RGB"))
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        if fov_masks is not None:
            fov = np.asarray(Image.open(fov_masks[i]).convert("L"))
            sel = fov > 0
            brightness.append(gray[sel].mean() if sel.any() else gray.mean())
        else:
            brightness.append(gray.mean())
    target = float(np.mean(brightness)) if brightness else None

    outs = []
    for i, p in enumerate(image_paths):
        img = np.asarray(Image.open(p).convert("RGB"))
        fov = (np.asarray(Image.open(fov_masks[i]).convert("L"))
               if fov_masks is not None else None)
        out = clahe_gridsize(img, fov, denoise=denoise,
                             brightness_target=target)
        out_path = out_dir / Path(p).name
        Image.fromarray(out).save(out_path, quality=100, subsampling=0)
        outs.append(out_path)
    return outs


# FGADR Seg-set mask-directory names -> lesion codes (the reference's broken
# build_fgadr.py:7-20 sketches this walk; lesion codes from
# util/base_utils.py:34-37 / our paths.LESION_DICT *_FGADR entries)
FGADR_MASK_DIRS = {
    "HardExudate_Masks": "EX",
    "Hemohedge_Masks": "HE",
    "SoftExudate_Masks": "SE",
    "Microaneurysms_Masks": "MA",
}


def build_fgadr_dataset(seg_set_dir: Path, dest_dir: Path,
                        split: float = 0.8, seed: int = 1999) -> Dict[str, int]:
    """Index the FGADR Seg-set into the processed layout ``get_datapath``'s
    FGADR branch consumes (paths.py:60: images ``*.png`` + per-lesion mask
    dirs with the SAME stem names).

    A working replacement for the reference's broken ``build_fgadr.py``
    (undefined ``self.dir`` / ``img_name``, build_fgadr.py:10-20): walk
    ``Original_Images`` and each ``*_Masks`` dir, pair by 8-char stem prefix
    (the reference's ``f[:8]`` convention), deterministic seed-1999 split as
    in build_chasedb.py:22-24.

    Returns per-part image counts.
    """
    from PIL import Image

    seg_set_dir = Path(seg_set_dir)
    dest_dir = Path(dest_dir)
    img_dir = seg_set_dir / "Original_Images"
    images = sorted(img_dir.glob("*.png"))
    if not images:
        raise FileNotFoundError(f"no *.png under {img_dir}")
    # per-lesion mask lookup by 8-char stem prefix (reference f[:8])
    mask_index: Dict[str, Dict[str, Path]] = {d: {} for d in FGADR_MASK_DIRS}
    for mask_sub in FGADR_MASK_DIRS:
        for f in sorted((seg_set_dir / mask_sub).glob("*.png")):
            mask_index[mask_sub][f.stem[:8]] = f

    order = np.arange(len(images))
    np.random.RandomState(seed).shuffle(order)
    n_train = int(round(len(images) * split))
    counts = {"train": 0, "test": 0}
    for rank, idx in enumerate(order):
        part = "train" if rank < n_train else "test"
        src = images[idx]
        out_img = dest_dir / part / "image"
        out_img.mkdir(parents=True, exist_ok=True)
        Image.open(src).convert("RGB").save(out_img / src.name)
        key = src.stem[:8]
        for mask_sub in FGADR_MASK_DIRS:
            m = mask_index[mask_sub].get(key)
            out_mask = dest_dir / part / "label" / mask_sub
            out_mask.mkdir(parents=True, exist_ok=True)
            if m is not None:
                Image.open(m).convert("L").save(out_mask / (src.stem + ".png"))
            else:
                # FGADR grades without a lesion have no mask file; write an
                # explicit empty mask so image/mask lists stay aligned
                Image.new("L", Image.open(src).size, 0).save(
                    out_mask / (src.stem + ".png"))
        counts[part] += 1
    return counts
