"""Multi-checkpoint ensemble inference (torch port).

Counterpart of ``eyediseasesegmentation_tpu/infer/ensemble.py``: each run
directory gives a model rebuilt from its own ``config.json`` and best
checkpoint, wrapped in a ``TTAPredictor``, so the members may differ in
architecture. Per batch the members' TTA probabilities are averaged on the
device; the per-image AP, the PR sweep, the threshold search and the mask
export then run once on the ensemble's probabilities.

The JAX package's ``make_sharded_ensemble`` (one member per device, a
psum-mean) needs several devices: it and ``predict(mesh=...)`` wait for the
multi-GPU port and raise.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Sequence

import torch

from ..data import TestSegmentation, get_datapath
from ..data.datasets import batch_iterator, prefetch
from .tta import (TTAPredictor, export_masks_on_device,
                  load_model_for_inference, tta_pass)

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")

SHARDED = ("the device-axis ensemble (one member per GPU) comes with the "
           "multi-GPU port, ROADMAP.md queue 1 item D5")


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


def make_sharded_ensemble(predictors: Sequence[TTAPredictor], mesh):
    raise NotImplementedError(SHARDED)


def predict(config: Dict[str, Any], logdirs: Sequence, out_dir,
            tta: str = "d4", batch_size: int = 2, mesh=None,
            device=None) -> Dict[str, Any]:
    """The ensemble's mean prediction over the test directory of
    ``config``, its mean per-image AP, the threshold search (the PR figure
    under ``out_dir/figures``) and the masks at ``optimal_threshold_2``
    under ``out_dir/masks``. Returns {'mean_auc', 'thresholds', 'out_dir'}.
    """
    if mesh is not None:
        raise NotImplementedError(SHARDED)
    from ..analysis.aucpr import pr_curve_report

    img_paths, mask_paths = get_datapath(Path(config["test_img_path"]),
                                         Path(config["test_mask_path"]),
                                         config.get("lesion_type", "EX"))
    ds = TestSegmentation(img_paths, mask_paths,
                          gray=config.get("gray", False))
    first = ds[0]
    ensemble = EnsemblePredictor(get_best_models(
        logdirs, tta=tta, ori_hw=(first["ori_h"], first["ori_w"]),
        device=device))
    totals, prob_batches, _ = tta_pass(
        ensemble, prefetch(batch_iterator(ds, batch_size, shuffle=False,
                                          workers=min(4, batch_size))))
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    out_dir = Path(out_dir)
    thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                 "ensemble", figure_dir=out_dir / "figures")
    mask_dir = out_dir / "masks"
    mask_dir.mkdir(parents=True, exist_ok=True)
    export_masks_on_device(
        ((p, [Path(n).stem + ".jpg" for n in fnames])
         for p, fnames in prob_batches),
        thresholds["optimal_threshold_2"], mask_dir)
    logger.info("ensemble MEAN-AUC %.5f", mean_auc)
    return {"mean_auc": mean_auc, "thresholds": thresholds,
            "out_dir": str(mask_dir)}
