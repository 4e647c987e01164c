"""Standalone checkpoint evaluation, whole-image mode (torch port).

Counterpart of the repository's ``evaluate.py`` (reference
``src/main/dice.py``): per test image of a trained run directory, dice, IoU,
precision and recall at ``--threshold`` and the average precision, after
TTA at the run's ``scale_size``, as one table (``log_pretty_table``) with an
``Avg:`` row. The model runs on the GPU unless ``--device cpu`` is given.

    python -m eyediseasesegmentation_tpu_torch.evaluate --logdir RUN \
        [--tta d4] [--threshold 0.5] [--config overrides.json] [--device cpu]

``--tiled`` (sliding-window evaluation) raises NotImplementedError until
``ops/tiling.py`` is ported (ROADMAP.md, queue 1, item D: tiled inference).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import TestConfig
from .data import TestSegmentation, get_datapath
from .data.datasets import batch_iterator
from .infer.tta import TTAPredictor, load_model_for_inference
from .ops import metrics as M
from .utils import log_pretty_table

COLUMNS = ["image", "dice", "iou", "precision", "recall", "AP"]


def main(argv: Optional[Sequence[str]] = None) -> List[list]:
    """Run the evaluation; returns the table's rows (the last is ``Avg:``)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--logdir", required=True)
    parser.add_argument("--tta", default="d4")
    parser.add_argument("--best", default="true")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--tiled", action="store_true",
                        help="sliding-window evaluation (not ported yet)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device of the model (default: the GPU)")
    args = parser.parse_args(argv)
    if args.tiled:
        raise NotImplementedError(
            "evaluate --tiled needs ops/tiling.py, which is not ported yet "
            "(ROADMAP.md, queue 1, item D: tiled inference)")

    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
    cfg = TestConfig.from_dict({**TestConfig().get_all_attributes(),
                                **overrides}).get_all_attributes()
    model, run_cfg = load_model_for_inference(
        args.logdir, best=args.best.lower() == "true", device=args.device)
    cfg = {**run_cfg, **cfg}
    img_paths, mask_paths = get_datapath(Path(cfg["test_img_path"]),
                                         Path(cfg["test_mask_path"]),
                                         cfg.get("lesion_type", "EX"))
    # whole-image mode scores against the reference's GT geometry
    ds = TestSegmentation(img_paths, mask_paths, gray=cfg.get("gray", False),
                          metric_roundtrip_scale=int(cfg.get("scale_size",
                                                             1024)))
    first = ds[0]
    predictor = TTAPredictor(model, cfg, tta=args.tta,
                             ori_hw=(first["ori_h"], first["ori_w"]))

    rows = []
    for batch in batch_iterator(ds, args.batch_size, shuffle=False):
        probs = predictor.predict(batch["image"])
        with torch.inference_mode():
            for i in range(batch["n_valid"]):
                p = probs[i]
                g = torch.from_numpy(batch["mask"][i]).to(p.device)
                s = M.per_image_stats((p > args.threshold).float(), g)
                ap = (float(M.average_precision(p, g))
                      if float(torch.sum(g)) > 0 else float("nan"))
                rows.append([batch["filename"][i],
                             round(float(s["dice"]), 4),
                             round(float(s["iou"]), 4),
                             round(float(s["ppv"]), 4),
                             round(float(s["sn"]), 4),
                             round(ap, 4) if np.isfinite(ap) else "n/a"])
    means = [np.mean([r[i] for r in rows if isinstance(r[i], float)])
             for i in range(1, 5)]
    rows.append(["Avg:"] + [round(float(m), 4) for m in means] + [""])
    log_pretty_table(COLUMNS, rows)
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
