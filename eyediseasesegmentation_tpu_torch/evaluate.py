"""Standalone checkpoint evaluation, whole-image mode (torch port).

Counterpart of the repository's ``evaluate.py`` (reference
``src/main/dice.py``): per test image of a trained run directory, dice, IoU,
precision and recall at ``--threshold`` and the average precision, after
TTA at the run's ``scale_size``, as one table (``log_pretty_table``) with an
``Avg:`` row. The model runs on the GPU unless ``--device cpu`` is given.
``--tiled`` predicts each image by sliding window (``ops.tiling``) with the
same TTA views per tile, and scores against the masks as they are. Under
``torchrun`` rank 0 alone evaluates and prints; the other ranks return.

    python -m eyediseasesegmentation_tpu_torch.evaluate --logdir RUN \
        [--tta d4] [--tiled] [--threshold 0.5] [--config overrides.json] \
        [--device cpu]
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
from .ops.tiling import tiled_predict
from .parallel.mesh import is_main_process
from .utils import log_pretty_table, make_grid

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
                        help="sliding-window evaluation instead of the "
                             "whole-image resize path (reference "
                             "dice.py:33-151)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device of the model (default: the GPU)")
    args = parser.parse_args(argv)
    if not is_main_process():
        return []

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
    ds = TestSegmentation(
        img_paths, mask_paths, gray=cfg.get("gray", False),
        metric_roundtrip_scale=(None if args.tiled
                                else int(cfg.get("scale_size", 1024))))
    first = ds[0]
    hw = (first["ori_h"], first["ori_w"])
    predictor = TTAPredictor(model, cfg, tta=args.tta, ori_hw=hw,
                             resize=not args.tiled)

    def predictions():
        """(file name, device probabilities (H, W), device mask)."""
        if not args.tiled:
            for batch in batch_iterator(ds, args.batch_size, shuffle=False):
                probs = predictor.predict(batch["image"])
                for i in range(batch["n_valid"]):
                    g = torch.from_numpy(batch["mask"][i])
                    yield batch["filename"][i], probs[i], g.to(probs.device)
            return
        scale_size = int(cfg.get("scale_size", 1024))
        window = min(2 * scale_size, *hw)
        grid = make_grid(hw, window=window, min_overlap=32)
        for i in range(len(ds)):
            s = ds[i]
            if (s["ori_h"], s["ori_w"]) != hw:
                raise ValueError(
                    f"{s['filename']} is {(s['ori_h'], s['ori_w'])} but the "
                    f"tile grid was built for the first image's {hw}")
            image = torch.from_numpy(s["image"]).to(predictor.device)
            with torch.inference_mode():
                probs = tiled_predict(predictor.predict_tile, image, grid,
                                      window, scale_size)
            yield (s["filename"], probs,
                   torch.from_numpy(s["mask"]).to(probs.device))

    rows = []
    for name, p, g in predictions():
        with torch.inference_mode():
            s = M.per_image_stats((p > args.threshold).float(), g)
            ap = (float(M.average_precision(p, g))
                  if float(torch.sum(g)) > 0 else float("nan"))
        rows.append([name, round(float(s["dice"]), 4),
                     round(float(s["iou"]), 4), round(float(s["ppv"]), 4),
                     round(float(s["sn"]), 4),
                     round(ap, 4) if np.isfinite(ap) else "n/a"])
    means = [np.mean([r[i] for r in rows if isinstance(r[i], float)])
             for i in range(1, 5)]
    rows.append(["Avg:"] + [round(float(m), 4) for m in means] + [""])
    log_pretty_table(COLUMNS, rows)
    return rows


if __name__ == "__main__":
    # under torchrun the other ranks log warnings only
    logging.basicConfig(level=logging.INFO if is_main_process()
                        else logging.WARNING)
    main()
