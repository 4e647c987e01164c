"""Datasets: host-side decode feeding the device (torch port).

Counterpart of ``eyediseasesegmentation_tpu/data/datasets.py``: the host
decodes files to uint8 numpy arrays (plus the dynamic-shape Ben crop when
asked for) and stacks fixed-shape batches; resize, pad, normalization and
augmentation run on the device, in the predictor or the trainer. PIL and cv2
are imported where a file is decoded, so the package imports without them.
``train_val_split`` draws from numpy's ``RandomState(seed)``, so its split is
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..ops.image import longest_max_size_shape


def _load_rgb(path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _load_mask(path) -> np.ndarray:
    """Grayscale mask, binarized at >50 → {0,1} (lesion_dataset.py:54-58)."""
    from PIL import Image
    m = np.asarray(Image.open(path).convert("L"), dtype=np.uint8)
    return (m > 50).astype(np.float32)


def ben_color_host(image: np.ndarray, sigma: float = 10.0,
                   img_size: Optional[Tuple[int, int]] = None,
                   tol: int = 7) -> np.ndarray:
    """Full Ben-Graham preprocessing incl. the dynamic-shape gray-crop
    (reference data_transform.py:181-203), on the host because the crop's
    output shape depends on the data."""
    import cv2

    img = image
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    nz = gray > tol
    if nz.any():
        rows = nz.any(1)
        cols = nz.any(0)
        cropped = img[np.ix_(rows, cols)]
        if cropped.shape[0] > 0:
            img = cropped
    if img_size is not None:
        img = cv2.resize(img, (img_size[0], img_size[1]))
    blur = cv2.GaussianBlur(img, (0, 0), sigma)
    return cv2.addWeighted(img, 4, blur, -4, 128)


@dataclasses.dataclass
class OneLesionSegmentation:
    """Train/val dataset of paired image / mask files (reference
    lesion_dataset.py:38-91). ``__getitem__`` returns host arrays: the image
    uint8 (fp32 luma repeated over three channels with ``gray``), the mask
    {0, 1} fp32; ``with_label`` adds the per-patch label ``mask.sum() > 0``.
    """

    image_paths: Sequence[Path]
    mask_paths: Sequence[Path]
    gray: bool = False
    ben_transform: bool = False
    with_label: bool = False

    def __post_init__(self):
        assert len(self.image_paths) == len(self.mask_paths), (
            len(self.image_paths), len(self.mask_paths))

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        img = _load_rgb(self.image_paths[idx])
        mask = _load_mask(self.mask_paths[idx])
        if self.ben_transform:
            img = ben_color_host(img)       # uint8 in, uint8 out
            if img.shape[:2] != mask.shape:
                import cv2
                mask = cv2.resize(mask, (img.shape[1], img.shape[0]),
                                  interpolation=cv2.INTER_NEAREST)
        if self.gray:
            g = img.astype(np.float32) @ np.array([0.2989, 0.5870, 0.1140],
                                                  np.float32)
            img = np.repeat(g[..., None], 3, axis=-1)
        sample = {"image": img, "mask": mask,
                  "image_id": Path(self.image_paths[idx]).stem}
        if self.with_label:
            sample["label"] = np.float32(mask.sum() > 0)
        return sample


def train_val_split(items_a: Sequence, items_b: Sequence,
                    val_size: float = 0.2, seed: int = 1999):
    """The JAX package's deterministic split (the role of sklearn's
    train_test_split(random_state=seed), reference train.py:66-75)."""
    n = len(items_a)
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    n_val = max(1, int(round(n * val_size))) if n > 1 else 0
    val_idx = set(order[:n_val].tolist())
    tr_a = [items_a[i] for i in range(n) if i not in val_idx]
    tr_b = [items_b[i] for i in range(n) if i not in val_idx]
    va_a = [items_a[i] for i in range(n) if i in val_idx]
    va_b = [items_b[i] for i in range(n) if i in val_idx]
    return (tr_a, tr_b), (va_a, va_b)


def reference_gt_roundtrip(mask01: np.ndarray, scale_size: int) -> np.ndarray:
    """The reference's GT geometry for whole-image metric evaluation.

    The reference's test mask rides the image's LongestMaxSize (nearest) +
    PadIfNeeded, and the eval generator center-crops the pad away and
    linear-resizes back to H×W as uint8 (tta.py:115-121, lesion_dataset.py:
    130-137). Pad and crop cancel, so the net effect is a nearest downscale
    to the LongestMaxSize shape and a cv2.INTER_LINEAR upscale back: AUC-PR
    and the sweep are scored against that GT. cv2 when it imports (bit-exact
    with the reference), else a half-pixel numpy bilinear."""
    h, w = mask01.shape[:2]
    nh, nw = longest_max_size_shape(h, w, scale_size)
    if (nh, nw) == (h, w):
        return mask01
    m = mask01.astype(np.uint8)
    try:
        import cv2
        m = cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST)
        m = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
        return m.astype(np.float32)
    except ImportError:
        def _grid(n_out, n_in):  # half-pixel source coordinates
            return (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        yi = np.clip(np.round(_grid(nh, h)).astype(int), 0, h - 1)
        xi = np.clip(np.round(_grid(nw, w)).astype(int), 0, w - 1)
        m = m[yi][:, xi]  # INTER_NEAREST
        ys, xs = _grid(h, nh), _grid(w, nw)
        y0 = np.clip(np.floor(ys).astype(int), 0, nh - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, nw - 1)
        y1, x1 = np.minimum(y0 + 1, nh - 1), np.minimum(x0 + 1, nw - 1)
        fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
        fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
        mf = m.astype(np.float64)
        out = ((1 - fy) * (1 - fx) * mf[y0][:, x0]
               + (1 - fy) * fx * mf[y0][:, x1]
               + fy * (1 - fx) * mf[y1][:, x0]
               + fy * fx * mf[y1][:, x1])
        return np.rint(out).astype(np.float32)


@dataclasses.dataclass
class TestSegmentation:
    """Test dataset (lesion_dataset.py:95-145): images (+ optional GT masks),
    original sizes recorded for the resize-back step.

    ``metric_roundtrip_scale``: when set (the whole-image lesion eval path),
    masks go through :func:`reference_gt_roundtrip` at this scale_size so
    metrics score against the reference's GT geometry."""

    image_paths: Sequence[Path]
    mask_paths: Optional[Sequence[Path]] = None
    gray: bool = False
    ben_transform: bool = False
    metric_roundtrip_scale: Optional[int] = None

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        img = _load_rgb(self.image_paths[idx])  # uint8 on the wire
        sample = {"image": img, "filename": Path(self.image_paths[idx]).name,
                  "ori_h": img.shape[0], "ori_w": img.shape[1]}
        if self.ben_transform:
            sample["image"] = ben_color_host(img)
        if self.gray:
            g = (sample["image"].astype(np.float32)
                 @ np.array([0.2989, 0.5870, 0.1140], np.float32))
            sample["image"] = np.repeat(g[..., None], 3, axis=-1)
        if self.mask_paths is not None:
            mask = _load_mask(self.mask_paths[idx])
            if self.metric_roundtrip_scale:
                mask = reference_gt_roundtrip(mask,
                                              self.metric_roundtrip_scale)
            sample["mask"] = mask
        return sample


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   drop_last: bool = False, seed: int = 0,
                   pad_to_batch: bool = True,
                   workers: int = 0) -> Iterator[dict]:
    """Fixed-shape numpy batches (the role of torch's DataLoader here).

    All images of a dataset are assumed to share one shape; a short final
    batch is zero-padded to ``batch_size`` with ``n_valid`` set.
    ``workers`` > 0 decodes a batch's samples in a thread pool (PIL and
    numpy release the GIL while decoding); combine with :func:`prefetch` to
    overlap decode with device work."""
    pool = None
    if workers and len(dataset) > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=workers)
    try:
        order = np.arange(len(dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size and drop_last:
                return
            if pool is not None:
                samples = list(pool.map(dataset.__getitem__, idxs))
            else:
                samples = [dataset[i] for i in idxs]
            batch = {}
            for key in samples[0]:
                vals = [s[key] for s in samples]
                if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
                    arr = np.stack([np.asarray(v) for v in vals])
                    if pad_to_batch and arr.shape[0] < batch_size:
                        pad = batch_size - arr.shape[0]
                        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
                        arr = np.pad(arr, widths)
                    batch[key] = arr
                else:
                    batch[key] = vals  # e.g. filenames
            batch["n_valid"] = len(idxs)
            yield batch
    finally:
        if pool is not None:
            # wait=True: abandoning the generator mid-way must not leave
            # threads reading the dataset
            pool.shutdown(wait=True)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, ``size`` items ahead, so
    host decode overlaps device work; an exception in the producer is
    raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item
