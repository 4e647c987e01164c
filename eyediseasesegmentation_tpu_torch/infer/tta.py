"""Whole-image test-time-augmentation inference (torch port).

Counterpart of ``eyediseasesegmentation_tpu/infer/tta.py`` for whole-image
mode: ``load_model_for_inference`` rebuilds a model from a run directory
(``config.json`` and an msgpack checkpoint in the JAX package's format);
``TTAPredictor`` runs the V views of a batch (``d4``, ``flip``, ``hflip``,
``none``) as one forward, inverts and averages their logits and applies one
sigmoid (sigmoid of the mean, not the mean of sigmoids); with a ``mesh``
the fused V·B view batch is split over its ranks and the logits gathered,
so every rank returns the probabilities; ``test_tta`` runs a
test directory through it once, scores it on the device (per-image AP or
ROC-AUC and the 19-threshold sweep), picks the optimal thresholds and
exports uint8 masks.

``test_tta`` is made of two pieces a caller can drive without files:
``tta_pass`` (predict + metrics over ``batch_iterator``-shaped batches) and
``masks_to_uint8`` (the device half of the mask export). ``tta_patches`` is
the sliding-window counterpart (reference tta.py:150-244): ``tiled_pass``
runs each test image through ``ops.tiling.tiled_predict`` with the same
fused TTA views per tile, then the same AUC, threshold search and export.

The ``multiscale`` alias averages the logits of scales 1, 2 and 4; a scale
whose upsampled side exceeds ``multiscale_max_res`` runs as s² tiles of the
model's size. ``five_crop`` / ``ten_crop`` predict half-size crops. A model
built for one input size (the axial flagship) raises ``ValueError`` on any
other, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import models as zoo
from ..convert import load_flax
from ..data import TestSegmentation, get_datapath, get_transform
from ..data.datasets import batch_iterator, prefetch
from ..ops import image as I
from ..ops import metrics as M
from ..ops.tiling import tiled_predict, tiled_predict_sharded
from ..parallel import mesh as P
from ..train.checkpoint import load_checkpoint
from ..utils import make_grid, save_output

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


# ---------------------------------------------------------------------------
# TTA view families: (V, B, H, W, C) stacks and their inverses
# ---------------------------------------------------------------------------

def _flip_views(img):  # ttach HFlip x VFlip compose: 4 combinations
    return torch.stack([img, I.hflip(img), I.vflip(img),
                        I.vflip(I.hflip(img))], 0)


def _flip_inverse(views):
    return torch.stack([views[0], I.hflip(views[1]), I.vflip(views[2]),
                        I.hflip(I.vflip(views[3]))], 0)


def _hflip_views(img):
    return torch.stack([img, I.hflip(img)], 0)


def _hflip_inverse(views):
    return torch.stack([views[0], I.hflip(views[1])], 0)


TTA_FAMILIES: Dict[str, Tuple[Callable, Callable, int]] = {
    "d4": (I.d4_views, I.d4_inverse, 8),
    "flip": (_flip_views, _flip_inverse, 4),
    "hflip": (_hflip_views, _hflip_inverse, 2),
    "none": (lambda x: x[None], lambda v: v, 1),
}

MULTISCALE_SCALES = (1, 2, 4)
TTA_ALIASES = (*TTA_FAMILIES, "multiscale", "five_crop", "ten_crop")


# ---------------------------------------------------------------------------
# Model (re)construction from a run directory
# ---------------------------------------------------------------------------

def load_model_for_inference(logdir, best: bool = True,
                             dtype: torch.dtype = torch.bfloat16,
                             device=None) -> Tuple[torch.nn.Module, dict]:
    """Rebuild the model of ``<logdir>/config.json`` with the inference
    demotions and load ``checkpoints/best.ckpt`` (``last.ckpt`` when not
    ``best``). Returns (model, config).

    ``inference_dtype`` in config.json overrides ``dtype``. The model is
    built on ``device``: ``None`` means the GPU and raises without one, as
    ``models.get_model`` does. ``model_params`` go through as they are:
    ``pallas_tail`` selects the kernel routes here even where
    ``fast_inference`` is false, which in the JAX package turns them off
    (a deliberate divergence, ROADMAP.md section 3)."""
    logdir = Path(logdir)
    with open(logdir / "config.json") as f:
        config = json.load(f)
    if config.get("inference_dtype"):
        dtype = getattr(torch, config["inference_dtype"])
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"inference_dtype {config['inference_dtype']!r}"
                             " is not a torch dtype")
    model = zoo.get_model(config["model_name"],
                          dict(config.get("model_params") or {}),
                          training=False, dtype=dtype, device=device)
    ckpt = load_checkpoint(logdir / "checkpoints"
                           / ("best.ckpt" if best else "last.ckpt"))
    state = ckpt["model_state_dict"]
    load_flax(model, {"params": state["params"],
                      "batch_stats": state.get("batch_stats", {})})
    return model, config


# ---------------------------------------------------------------------------
# The predictor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TTAPredictor:
    """``predict(raw_images)`` maps (B, H0, W0, 3) raw images in [0, 255] to
    (B, H0, W0) probabilities at the original resolution: resize + pad +
    normalize → the alias's views (d4, flip, hflip, none: one batched
    forward) → inverse views → mean of the logits → sigmoid → crop the
    pad → resize back. With ``resize=False`` (vessel mode, reference
    tta_vessel.py:76) the images are only normalized: they come padded to a
    square and leave at that size. The model's device and ``dtype`` are
    used. ``multiscale_max_res``: the largest side of a monolithic
    multiscale forward; larger scales run tiled (at scale_size 1024, scale 4
    would be a 4096² forward). ``mesh`` (``parallel.make_mesh``): the
    view families' V·B forward batch is split over its data axis (d4's 8
    views onto 8 GPUs), which must divide it; the model's weights are
    rank 0's (broadcast here); the other aliases run whole on every
    rank."""

    model: torch.nn.Module
    config: Dict[str, Any]
    tta: str = "d4"
    ori_hw: Optional[Tuple[int, int]] = None
    resize: bool = True
    multiscale_max_res: int = 2048
    mesh: Optional[P.Mesh] = None

    def __post_init__(self):
        if self.tta not in TTA_ALIASES:
            raise KeyError(f"Unknown TTA alias '{self.tta}'. Options: "
                           f"{list(TTA_ALIASES)}")
        cfg = self.config
        self.scale_size = int(cfg.get("scale_size", 1024))
        prep_fn, _, _ = zoo.get_preprocessing_fn(
            cfg.get("dataset_name", "IDRiD"), cfg.get("gray", False))
        self.transform = get_transform("normal")(image_size=self.scale_size,
                                                 preprocessing_fn=prep_fn)
        self.device = next(self.model.parameters()).device
        if self.mesh is not None and self.mesh.size > 1:
            P.replicate(self.model, self.mesh)

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) → fp32 logits (N, H, W). The input is cast to the
        model's dtype, as the JAX model's first conv casts it."""
        out = self.model(images.to(self.model.dtype).permute(0, 3, 1, 2))
        if isinstance(out, tuple):
            out = out[0]
        return out.to(torch.float32)[:, 0]

    def _scaled_logits_tiled(self, imgs: torch.Tensor, s: int
                             ) -> torch.Tensor:
        """The scale-s leg (s > 1) without the (B, sH, sW) activations of a
        monolithic forward: the upsampled image (3 channels) is cut into s²
        tiles of the model's size, their logits pasted into a 1-channel
        canvas, which is resized back down. Slicing the resized image is
        what the JAX package's ``scale_and_translate`` per tile computes.
        Tile forwards equal the whole-image forward only up to the
        receptive field cut at the seams, as in tiled inference."""
        n, h, w, _ = imgs.shape
        up = I.resize(imgs, (s * h, s * w))
        canvas = imgs.new_zeros((n, s * h, s * w), dtype=torch.float32)
        for i in range(s):
            for j in range(s):
                win = (slice(None), slice(i * h, (i + 1) * h),
                       slice(j * w, (j + 1) * w))
                canvas[win] = self._forward(up[win])
        return I.resize(canvas[..., None], (h, w))[..., 0]

    def _multiscale_logits(self, imgs: torch.Tensor) -> torch.Tensor:
        """Mean of the logits at scales 1, 2, 4 (bilinear up without
        antialias, forward, back down), at (B, S, S)."""
        n, h, w, _ = imgs.shape
        acc = 0.0
        for s in MULTISCALE_SCALES:
            if s == 1:
                p = self._forward(imgs)
            elif s * max(h, w) > self.multiscale_max_res:
                p = self._scaled_logits_tiled(imgs, s)
            else:
                p = self._forward(I.resize(imgs, (h * s, w * s)))
                p = I.resize(p[..., None], (h, w))[..., 0]
            acc = acc + p
        return acc / len(MULTISCALE_SCALES)

    def _crop_logits(self, imgs: torch.Tensor) -> torch.Tensor:
        """five_crop: the 4 corners and the centre at S/2, their logits
        pasted back and divided by each pixel's count; ten_crop adds the
        same crops of the hflipped image, flipped back."""
        n, s = imgs.shape[0], imgs.shape[1]
        cs = s // 2
        corners = [(0, 0), (0, s - cs), (s - cs, 0), (s - cs, s - cs),
                   ((s - cs) // 2, (s - cs) // 2)]
        batches = [imgs] if self.tta == "five_crop" else [imgs,
                                                          I.hflip(imgs)]
        acc = imgs.new_zeros((n, s, s), dtype=torch.float32)
        cnt = imgs.new_zeros((s, s), dtype=torch.float32)
        for flipped, im in enumerate(batches):
            for y, x in corners:
                p = self._forward(im[:, y:y + cs, x:x + cs])
                if flipped:
                    p, x = p.flip(-1), s - cs - x
                acc[:, y:y + cs, x:x + cs] += p
                cnt[y:y + cs, x:x + cs] += 1.0
        return acc / cnt.clamp_min(1.0)

    def _tta_probs(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, S, S, C) normalized → TTA-merged probabilities (B, S, S): one
        sigmoid after the merge of the logits, in every family."""
        if self.tta == "multiscale":
            return torch.sigmoid(self._multiscale_logits(imgs))
        if self.tta in ("five_crop", "ten_crop"):
            return torch.sigmoid(self._crop_logits(imgs))
        make_views, inverse, _ = TTA_FAMILIES[self.tta]
        # cast before building the views: they are pure permutations and the
        # first conv casts its input anyway, so the stack is half the bytes
        views = make_views(imgs.to(self.model.dtype))
        v, b, h, w, c = views.shape
        flat = views.reshape(v * b, h, w, c)
        if self.mesh is not None and self.mesh.axis_size() > 1:
            n = self.mesh.axis_size()
            if (v * b) % n:
                raise ValueError(
                    f"TTAPredictor: {v} views × batch {b} = {v * b} forward "
                    f"images do not split over {n} ranks")
            logits = P.all_gather(
                self._forward(flat[P.batch_rows(self.mesh, v * b)]),
                self.mesh)
        else:
            logits = self._forward(flat)
        logits = inverse(logits.reshape(v, b, h, w)[..., None])[..., 0]
        return torch.sigmoid(logits.mean(0))

    def predict_tile(self, tile: torch.Tensor) -> torch.Tensor:
        """One (S, S, C) tile in [0, 255] → (S, S) probabilities: normalize,
        then the alias's views (the ``predict_fn`` of tiled inference)."""
        prep = self.transform.preprocessing_fn or (lambda x: x)
        with torch.inference_mode():
            return self._tta_probs(prep(tile)[None])[0]

    def _predict(self, raw_images: torch.Tensor) -> torch.Tensor:
        raw_images = raw_images.to(torch.float32)
        if not self.resize:
            prep = self.transform.preprocessing_fn or (lambda x: x)
            return self._tta_probs(prep(raw_images))
        probs = self._tta_probs(self.transform.test(raw_images))
        ori_h, ori_w = self.ori_hw or (raw_images.shape[1], raw_images.shape[2])
        crop_hw = I.longest_max_size_shape(ori_h, ori_w, self.scale_size)
        probs = I.center_crop(probs[..., None], crop_hw)
        return I.resize(probs, (ori_h, ori_w))[..., 0]

    def predict(self, raw_images) -> torch.Tensor:
        if isinstance(raw_images, np.ndarray):
            if not raw_images.flags.writeable:   # e.g. a decoded image
                raw_images = raw_images.copy()
            raw_images = torch.from_numpy(raw_images)
        raw_images = raw_images.to(self.device)
        if self.resize and self.ori_hw is not None:
            got = tuple(raw_images.shape[1:3])
            if got != tuple(self.ori_hw):
                raise ValueError(
                    f"TTAPredictor.ori_hw is pinned to {tuple(self.ori_hw)} "
                    f"(the first test image) but this batch is {got}. Mixed-"
                    "size test directories are not supported by the whole-"
                    "image path; run images of one size per pass.")
        with torch.inference_mode():
            return self._predict(raw_images)


# ---------------------------------------------------------------------------
# Whole-image inference pipeline (reference test_tta, tta.py:56-148)
# ---------------------------------------------------------------------------

def _str2bool(v) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def tta_pass(predictor: TTAPredictor, batches: Iterable[dict],
             score: str = "ap"
             ) -> Tuple[Dict[str, np.ndarray], List[Tuple[torch.Tensor,
                                                          List[str]]], float]:
    """One prediction pass over ``batch_iterator``-shaped batches (``image``
    uint8 (B, H, W, 3), ``mask`` (B, H, W), ``filename``, ``n_valid``), with
    ``batch_image_metrics`` on each batch's probabilities on their device.
    The counters come to the host one batch behind and add up there in fp32,
    as in the JAX package. Returns (totals, [(device probabilities (B, H,
    W), the batch's real file names)], seconds of the pass)."""
    totals: Dict[str, np.ndarray] = {}
    prob_batches: List[Tuple[torch.Tensor, List[str]]] = []

    def _materialize(entry):
        probs, stats, fnames = entry
        for k, v in stats.items():
            totals[k] = totals.get(k, 0) + v.cpu().numpy()
        prob_batches.append((probs, fnames))

    t_start = time.perf_counter()
    pending: deque = deque()
    for batch in batches:
        probs = predictor.predict(batch["image"])
        # GT ships uint8 ({0, 1} exact, 4x less host-to-device)
        masks = torch.from_numpy(batch["mask"].astype(np.uint8)).to(
            probs.device)
        with torch.inference_mode():
            stats = M.batch_image_metrics(probs, masks, batch["n_valid"],
                                          score=score)
        pending.append((probs, stats,
                        list(batch["filename"][:batch["n_valid"]])))
        if len(pending) > 1:
            _materialize(pending.popleft())
    while pending:
        _materialize(pending.popleft())
    return totals, prob_batches, time.perf_counter() - t_start


def masks_to_uint8(probs: torch.Tensor, optim: float, with_probs: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The device half of the mask export: ``p > t`` and (``with_probs``)
    ``p * 255`` as uint8, on the device of ``probs``. The compare runs in
    fp32 and the cast truncates toward zero, as the JAX package's does."""
    t = torch.tensor(optim, dtype=torch.float32, device=probs.device)
    m8 = (probs > t).to(torch.uint8)
    p8 = (probs * 255.0).to(torch.uint8) if with_probs else None
    return m8, p8


def export_masks_on_device(prob_batches, optim, out_path, prob_path=None):
    """Binarize (and with ``prob_path`` quantize) predictions on their
    device and write the uint8 results, one batch behind the device.
    ``prob_batches``: iterable of (probabilities (B, H, W) or (H, W), [output
    file names]); the first len(names) images of a batch are written."""
    pending: deque = deque()

    def _save(entry):
        m8, p8, fnames = entry
        m = m8.cpu().numpy()
        q = None if p8 is None else p8.cpu().numpy()
        for i, name in enumerate(fnames):
            if q is not None:
                save_output(q[i], Path(prob_path) / name)
            save_output(m[i], Path(out_path) / name)

    for probs, fnames in prob_batches:
        if probs.ndim == 2:
            probs = probs[None]
        pending.append((*masks_to_uint8(probs, optim, prob_path is not None),
                        fnames))
        if len(pending) > 1:
            _save(pending.popleft())
    while pending:
        _save(pending.popleft())


def _curve_report(totals, metric: str, name: str, cfg: Dict[str, Any],
                  figure: bool = True):
    """The PR (lesion) or ROC (vessel) curve family of the pass's summed
    counters, its figure under outputs/<ds>/figures/<lesion>/ (unless
    ``figure`` is false), and the mean per-image AUC. Returns (mean_auc,
    thresholds, out_root)."""
    from ..analysis.aucpr import pr_curve_report, roc_curve_report

    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    out_root = Path(cfg.get("out_dir", "outputs")) / cfg["dataset_name"]
    figure_dir = (out_root / "figures" / cfg["lesion_type"] if figure
                  else None)
    if metric == "pr":
        thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                     name, figure_dir=figure_dir)
    else:
        thresholds = roc_curve_report(totals["tp"], totals["ap"],
                                      totals["tn"], totals["px"], name,
                                      figure_dir=figure_dir, pp=totals["pp"])
    logger.info("optimal thresholds: %s", thresholds)
    return mean_auc, thresholds, out_root


def test_tta(logdir, config: Dict[str, Any], args: Dict[str, Any],
             batch_size: int = 2, metric: str = "pr", resize: bool = True,
             device=None) -> Dict[str, Any]:
    """One TTA pass over the test directory, the AUC, the threshold search
    and the mask export.

    ``metric='pr'`` is the lesion path (mean per-image AP + PR sweep,
    tta.py:123-137); ``metric='roc'`` with ``resize=False`` the vessel path
    (AUC-ROC, no whole-image resize, tta_vessel.py:76,112-121). ``device``:
    where the model runs, as in :func:`load_model_for_inference`. Returns
    {'mean_auc', 'thresholds', 'out_dir'} and writes masks to
    outputs/<ds>/tta/<lesion>/<exp>/ (and prob_image/ with createprob)."""
    logdir = Path(logdir)
    model, run_cfg = load_model_for_inference(
        logdir, best=_str2bool(args.get("best", "true")), device=device)
    cfg = {**run_cfg, **config}

    img_paths, mask_paths = get_datapath(Path(cfg["test_img_path"]),
                                         Path(cfg["test_mask_path"]),
                                         cfg.get("lesion_type", "EX"))
    ds = TestSegmentation(
        img_paths, mask_paths, gray=cfg.get("gray", False),
        ben_transform=cfg.get("use_ben_transform", False),
        # the lesion path scores against the reference's GT geometry
        # (reference_gt_roundtrip); the vessel path uses masks as they are
        metric_roundtrip_scale=(int(cfg.get("scale_size", 1024))
                                if resize else None))
    first = ds[0]
    predictor = TTAPredictor(model, cfg, tta=args.get("tta", "d4"),
                             ori_hw=(first["ori_h"], first["ori_w"]),
                             resize=resize)
    totals, prob_batches, elapsed = tta_pass(
        predictor,
        prefetch(batch_iterator(ds, batch_size, shuffle=False,
                                workers=min(4, batch_size))),
        score="ap" if metric == "pr" else "roc")
    n_images = sum(len(f) for _, f in prob_batches)
    mean_auc, thresholds, out_root = _curve_report(totals, metric,
                                                   logdir.name, cfg)
    logger.info("MEAN-AUC %.5f | %d images in %.1fs incl. decode+metrics "
                "(%.2f img/s)", mean_auc, n_images, elapsed,
                n_images / max(elapsed, 1e-9))
    optim = thresholds["optimal_threshold_2"]  # F-max (tta.py:137)

    out_path = out_root / "tta" / cfg["lesion_type"] / logdir.name
    out_path.mkdir(parents=True, exist_ok=True)
    prob_path = None
    if _str2bool(args.get("createprob", "false")):
        prob_path = (out_root / "tta" / cfg["lesion_type"] / "prob_image"
                     / logdir.name)
        prob_path.mkdir(parents=True, exist_ok=True)
    export_masks_on_device(
        ((p, [Path(n).stem + ".jpg" for n in fnames])
         for p, fnames in prob_batches),
        optim, out_path, prob_path)
    return {"mean_auc": mean_auc, "thresholds": thresholds,
            "out_dir": str(out_path)}


test_tta.__test__ = False  # keep pytest from collecting the API function


# ---------------------------------------------------------------------------
# Tiled (sliding-window) inference (reference tta_patches, tta.py:150-244)
# ---------------------------------------------------------------------------

def tiled_pass(tile_engine: TTAPredictor, dataset, grid, window: int,
               scale_size: int, metric: str = "pr", mesh=None
               ) -> Tuple[Dict[str, np.ndarray], List[Tuple[torch.Tensor,
                                                            str]]]:
    """Each image of ``dataset`` (``TestSegmentation``-shaped samples:
    ``image`` uint8 (H, W, 3), ``mask``, ``filename``) through
    :func:`ops.tiling.tiled_predict` on ``grid``, each tile through
    ``tile_engine.predict_tile``: the same fused TTA views as whole-image
    mode (the reference wraps the tiled model in ttach too,
    tta.py:173-180), with
    ``batch_image_metrics`` (AP for ``metric='pr'``, ROC-AUC for 'roc') on
    the image's probabilities on their device. Decode runs one image ahead
    (``prefetch``), counters come to the host one image behind. Every image
    must have the size the grid covers. ``mesh``: the tiles of each image
    are split over its ranks (:func:`ops.tiling.tiled_predict_sharded`),
    and every rank gets the whole map. Returns (totals, [(device
    probabilities (H, W), file name)])."""
    grid = np.asarray(grid)
    # the last tile of each axis ends at the image's edge
    hw = (int(grid[:, 1].max()), int(grid[:, 3].max()))
    totals: Dict[str, np.ndarray] = {}
    out: List[Tuple[torch.Tensor, str]] = []

    def _materialize(entry):
        probs, stats, name = entry
        for k, v in stats.items():
            totals[k] = totals.get(k, 0) + v.cpu().numpy()
        out.append((probs, name))

    pending: deque = deque()
    for s in prefetch(map(dataset.__getitem__, range(len(dataset)))):
        if (s["ori_h"], s["ori_w"]) != hw:
            raise ValueError(
                f"tiled inference grid was built for {hw} (the first test "
                f"image) but {s['filename']} is {(s['ori_h'], s['ori_w'])}; "
                "mixed-size test directories are not supported in one pass.")
        image = torch.from_numpy(np.ascontiguousarray(s["image"])).to(
            tile_engine.device)
        mask = torch.from_numpy(s["mask"].astype(np.uint8)).to(
            tile_engine.device)
        with torch.inference_mode():
            if mesh is not None:
                probs = tiled_predict_sharded(tile_engine.predict_tile, image,
                                              grid, window, scale_size, mesh)
            else:
                probs = tiled_predict(tile_engine.predict_tile, image, grid,
                                      window, scale_size)
            stats = M.batch_image_metrics(
                probs[None], mask[None],
                score="ap" if metric == "pr" else "roc")
        pending.append((probs, stats, s["filename"]))
        if len(pending) > 1:
            _materialize(pending.popleft())
    while pending:
        _materialize(pending.popleft())
    return totals, out


def tta_patches(logdir, config: Dict[str, Any], args: Dict[str, Any],
                metric: str = "pr", device=None, mesh=None
                ) -> Dict[str, Any]:
    """Sliding-window inference over the test directory, then the same AUC,
    threshold search and export as :func:`test_tta`.

    Windows of ``2·scale_size`` (at most the image's sides) with 32 pixels
    of overlap (tta.py:197) are resized to ``scale_size`` and back.
    ``metric='pr'`` is the lesion path (tta.py:216-236), ``metric='roc'``
    the vessel tiled path (tta_vessel.py:206-218). Masks are written under
    outputs/<ds>/tta/<lesion>/<exp>/ with IDRiD's ``_<LESION>`` suffix
    dropped from the names. ``device`` as in :func:`test_tta`. ``mesh``
    (``parallel.make_mesh``): each image's tiles are split over its ranks
    (:func:`ops.tiling.tiled_predict_sharded`, the reference's
    later-tile-wins rule kept exactly); every rank returns the result, and
    rank 0 alone writes the figure and the masks."""
    logdir = Path(logdir)
    if device is None and mesh is not None:
        device = mesh.device
    model, run_cfg = load_model_for_inference(
        logdir, best=_str2bool(args.get("best", "true")), device=device)
    cfg = {**run_cfg, **config}
    scale_size = int(cfg.get("scale_size", 1024))

    img_paths, mask_paths = get_datapath(Path(cfg["test_img_path"]),
                                         Path(cfg["test_mask_path"]),
                                         cfg.get("lesion_type", "EX"))
    ds = TestSegmentation(img_paths, mask_paths, gray=cfg.get("gray", False))
    tile_engine = TTAPredictor(model, cfg, tta=args.get("tta", "d4"),
                               resize=False)
    first = ds[0]
    window = min(2 * scale_size, first["ori_h"], first["ori_w"])
    grid = make_grid((first["ori_h"], first["ori_w"]), window=window,
                     min_overlap=32)
    if mesh is not None and mesh.size > 1:
        P.replicate(model, mesh)
    totals, probs = tiled_pass(tile_engine, ds, grid, window, scale_size,
                               metric, mesh)
    main = mesh is None or mesh.is_main
    mean_auc, thresholds, out_root = _curve_report(totals, metric,
                                                   logdir.name, cfg, main)
    logger.info("MEAN-AUC %.5f | %d images, tiled", mean_auc, len(probs))
    out_path = out_root / "tta" / cfg["lesion_type"] / logdir.name
    if not main:
        return {"mean_auc": mean_auc, "thresholds": thresholds,
                "out_dir": str(out_path)}
    out_path.mkdir(parents=True, exist_ok=True)
    # IDRiD name remap _<LESION>.tif → .jpg (tta.py:191,234)
    export_masks_on_device(
        ((p, [Path(n).stem.replace(f"_{cfg['lesion_type']}", "") + ".jpg"])
         for p, n in probs),
        thresholds["optimal_threshold_2"], out_path)
    return {"mean_auc": mean_auc, "thresholds": thresholds,
            "out_dir": str(out_path)}
