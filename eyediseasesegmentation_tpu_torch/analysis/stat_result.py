"""Per-image statistic CSVs (torch port).

A copy of ``eyediseasesegmentation_tpu/analysis/stat_result.py``, the
behavioral port of reference ``src/main/stat_result.py:13-105``: reads GT
masks and predicted binary masks, computes per-image SN/PPV/SP/IoU/Dice with
the reference's empty-set conventions (a ratio with a zero denominator is 1;
iou/dice get EPS/EPS = 1 when the union is empty), appends an "Avg:" row and
writes sn.csv / ppv.csv / sp.csv / iou.csv / dice.csv under
``outputs/<ds>/result_assessment/<lesion>/<exp>/``. Host numpy only; PIL is
imported where a mask is read.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict

import numpy as np

from ..data.paths import lesion_dict

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")

EPS = 1e-7


def _binarize(path) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("L")
    return (np.asarray(im) > 50).astype(np.uint8)


def export_result(save_dir: str, test_config: Dict) -> Path:
    """``save_dir`` is '<lesion>/<exp>' (reference pipeline.py:107)."""
    gt_dir = Path(test_config["test_mask_path"]) / lesion_dict[
        test_config["lesion_type"]].dir_name
    pred_dir = (Path(test_config["out_dir"]) / test_config["dataset_name"]
                / "tta" / save_dir)

    rows = {k: [] for k in ("name", "sn", "ppv", "sp", "iou", "dice")}
    for image_name in sorted(os.listdir(gt_dir)):
        gt = _binarize(gt_dir / image_name)
        if test_config["dataset_name"] == "IDRiD":
            pred_name = re.sub("_" + test_config["lesion_type"] + ".tif",
                               ".jpg", image_name)
        else:
            pred_name = re.sub(".tif", ".jpg", image_name)
        pred_path = pred_dir / pred_name
        if not pred_path.exists():
            logger.warning("missing prediction %s", pred_path)
            continue
        pred = _binarize(pred_path)

        tp = float(np.sum(gt & pred))
        ap = float(np.sum(gt))
        pp = float(np.sum(pred))
        fp = pp - tp
        an = gt.size - ap
        tn = an - fp
        union = ap + fp

        rows["name"].append(image_name)
        rows["sn"].append(1.0 if ap == 0 else tp / ap)
        rows["ppv"].append(1.0 if pp == 0 else tp / pp)
        rows["sp"].append(1.0 if an == 0 else tn / an)
        rows["iou"].append((tp + EPS * float(union == 0))
                           / (ap + fp + EPS))
        rows["dice"].append((2 * tp + EPS * float(union == 0))
                            / (tp + ap + fp + EPS))

    out_dir = (Path(test_config["out_dir"]) / test_config["dataset_name"]
               / "result_assessment" / save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for key in ("sn", "ppv", "sp", "iou", "dice"):
        vals = rows[key]
        names = rows["name"] + ["Avg:"]
        vals = vals + [float(np.mean(vals)) if vals else 0.0]
        arr = np.stack((np.asarray(names, object),
                        np.asarray(vals, object)), axis=1)
        np.savetxt(out_dir / f"{key}.csv", arr, delimiter=",", fmt="%s")
    logger.info("wrote result assessment CSVs to %s", out_dir)
    return out_dir
