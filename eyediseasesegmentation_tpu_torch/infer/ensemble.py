"""Multi-checkpoint ensemble inference (torch port).

Counterpart of ``eyediseasesegmentation_tpu/infer/ensemble.py``: each run
directory gives a model rebuilt from its own ``config.json`` and best
checkpoint, wrapped in a ``TTAPredictor``, so the members may differ in
architecture. Per batch the members' TTA probabilities are averaged on the
device; the per-image AP, the PR sweep, the threshold search and the mask
export then run once on the ensemble's probabilities.

``make_sharded_ensemble`` and ``predict(mesh=...)`` are the device-axis
ensemble: one member per rank of a mesh (``parallel.mesh``), members beyond
M zero-weight repeats of member 0, the mean ``psum(w·probs) / psum(w)``;
the members must share one architecture and preprocessing, as in JAX.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Sequence

import json

import torch

from ..data import TestSegmentation, get_datapath
from ..data.datasets import batch_iterator, prefetch
from ..parallel import mesh as P
from .tta import (TTAPredictor, export_masks_on_device,
                  load_model_for_inference, tta_pass)

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")

# the config keys the members of a sharded ensemble share (JAX's list)
SHARED_KEYS = ("model_name", "model_params", "scale_size", "gray",
               "use_ben_transform", "dataset_name")


def get_best_models(logdirs: Sequence, tta: str = "d4", ori_hw=None,
                    device=None) -> List[TTAPredictor]:
    """Every run's best checkpoint as a TTA predictor on ``device`` (None:
    the GPU)."""
    predictors = []
    for logdir in logdirs:
        model, cfg = load_model_for_inference(logdir, best=True,
                                              device=device)
        predictors.append(TTAPredictor(model, cfg, tta=tta, ori_hw=ori_hw))
    return predictors


class EnsemblePredictor:
    """``predict(raw_images)``: the mean of the members' TTA probabilities,
    summed in member order on the first member's device, as the JAX
    package's unsharded ensemble adds them."""

    def __init__(self, predictors: Sequence[TTAPredictor]):
        self.predictors = list(predictors)
        self.device = self.predictors[0].device

    def predict(self, raw_images) -> torch.Tensor:
        total = 0
        for p in self.predictors:
            total = total + p.predict(raw_images).to(self.device)
        return total / len(self.predictors)


def check_members(configs: Sequence[Dict[str, Any]], ttas: Sequence[str],
                  mesh) -> None:
    """The JAX package's ``ValueError`` for a device-axis ensemble whose
    members differ in model or preprocessing config (or TTA), and for more
    members than ranks."""
    n = mesh.axis_size()
    if len(configs) > n:
        raise ValueError(f"{len(configs)} members > {n} devices: the "
                         "device-axis ensemble holds one member per rank")
    ref = {k: configs[0].get(k) for k in SHARED_KEYS}
    for i, (cfg, tta) in enumerate(zip(configs[1:], ttas[1:]), 1):
        got = {k: cfg.get(k) for k in SHARED_KEYS}
        if got != ref or tta != ttas[0]:
            raise ValueError(
                f"sharded ensemble member {i} differs from member 0 in "
                f"model/preprocessing config: {got} vs {ref} "
                f"(tta {tta!r} vs {ttas[0]!r}); the device-axis ensemble "
                "requires identical architectures and preprocessing — use "
                "the unsharded path for heterogeneous ensembles.")


class ShardedEnsemble:
    """``predict(raw_images)``: this rank's member's TTA probabilities,
    weighted (0 for a padding repeat of member 0), ``psum``'d over the
    mesh's data axis and divided by the ``psum`` of the weights: the
    members' mean on every rank."""

    def __init__(self, member: TTAPredictor, weight: float, mesh):
        self.member, self.mesh = member, mesh
        self.device = member.device
        self.weight = torch.tensor(weight, dtype=torch.float32,
                                   device=self.device)

    def predict(self, raw_images) -> torch.Tensor:
        probs = self.member.predict(raw_images)
        with torch.inference_mode():
            total = P.psum(self.weight * probs, self.mesh)
            return total / P.psum(self.weight, self.mesh)


def make_sharded_ensemble(predictors: Sequence[TTAPredictor], mesh
                          ) -> ShardedEnsemble:
    """The device-axis ensemble of ``predictors`` (every rank passes the
    same M ≤ ranks members; rank r runs member r, ranks past M member 0 at
    weight 0). Raises ``ValueError`` as JAX does."""
    check_members([p.config for p in predictors],
                  [p.tta for p in predictors], mesh)
    r = mesh.axis_index()
    own = r < len(predictors)
    return ShardedEnsemble(predictors[r if own else 0], float(own), mesh)


def _check_run_dirs(logdirs: Sequence, tta: str, mesh) -> None:
    """:func:`check_members` on the run directories' ``config.json``."""
    configs = []
    for logdir in logdirs:
        with open(Path(logdir) / "config.json") as f:
            configs.append(json.load(f))
    check_members(configs, [tta] * len(configs), mesh)


def _sharded_member(logdirs: Sequence, mesh, tta: str, ori_hw,
                    device) -> ShardedEnsemble:
    """:func:`make_sharded_ensemble` where each rank loads only its own
    member's checkpoint."""
    r = mesh.axis_index()
    own = r < len(logdirs)
    model, cfg = load_model_for_inference(logdirs[r if own else 0],
                                          best=True, device=device)
    return ShardedEnsemble(TTAPredictor(model, cfg, tta=tta, ori_hw=ori_hw),
                           float(own), mesh)


def predict(config: Dict[str, Any], logdirs: Sequence, out_dir,
            tta: str = "d4", batch_size: int = 2, mesh=None,
            device=None) -> Dict[str, Any]:
    """The ensemble's mean prediction over the test directory of
    ``config``, its mean per-image AP, the threshold search (the PR figure
    under ``out_dir/figures``) and the masks at ``optimal_threshold_2``
    under ``out_dir/masks``. Returns {'mean_auc', 'thresholds', 'out_dir'}.
    ``mesh``: one member per rank, each loading only its own; every rank
    computes the result, rank 0 alone writes.
    """
    from ..analysis.aucpr import pr_curve_report

    if mesh is not None:
        _check_run_dirs(logdirs, tta, mesh)
    img_paths, mask_paths = get_datapath(Path(config["test_img_path"]),
                                         Path(config["test_mask_path"]),
                                         config.get("lesion_type", "EX"))
    ds = TestSegmentation(img_paths, mask_paths,
                          gray=config.get("gray", False))
    first = ds[0]
    ori_hw = (first["ori_h"], first["ori_w"])
    if mesh is not None:
        ensemble = _sharded_member(logdirs, mesh, tta, ori_hw,
                                   device or mesh.device)
    else:
        ensemble = EnsemblePredictor(get_best_models(
            logdirs, tta=tta, ori_hw=ori_hw, device=device))
    totals, prob_batches, _ = tta_pass(
        ensemble, prefetch(batch_iterator(ds, batch_size, shuffle=False,
                                          workers=min(4, batch_size))))
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    out_dir = Path(out_dir)
    main = mesh is None or mesh.is_main
    thresholds = pr_curve_report(
        totals["tp"], totals["ap"], totals["pp"], "ensemble",
        figure_dir=out_dir / "figures" if main else None)
    mask_dir = out_dir / "masks"
    if not main:
        return {"mean_auc": mean_auc, "thresholds": thresholds,
                "out_dir": str(mask_dir)}
    mask_dir.mkdir(parents=True, exist_ok=True)
    export_masks_on_device(
        ((p, [Path(n).stem + ".jpg" for n in fnames])
         for p, fnames in prob_batches),
        thresholds["optimal_threshold_2"], mask_dir)
    logger.info("ensemble MEAN-AUC %.5f", mean_auc)
    return {"mean_auc": mean_auc, "thresholds": thresholds,
            "out_dir": str(mask_dir)}
