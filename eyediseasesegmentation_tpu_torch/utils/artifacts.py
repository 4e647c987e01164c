"""Run-directory layout and artifact writers (torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/artifacts.py``: checkpoints
and ``config.json`` under ``models/<dataset>/<lesion>/<MonDD_HH_MM>/``, masks
and figures under ``outputs/`` (reference ``pipeline.py:29-115``), binary
masks written min-max-rescaled to uint8 (``util/base_utils.py:124-131``).
PIL is imported where an image is written.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


def minmax_normalize(img, norm_range=(0, 1), orig_range=(0, 255)):
    """Linear rescale from ``orig_range`` to ``norm_range`` (base_utils.py:74-79)."""
    norm = (img - orig_range[0]) / (orig_range[1] - orig_range[0])
    return norm * (norm_range[1] - norm_range[0]) + norm_range[0]


def save_output(pred_mask: np.ndarray, out_path: Union[str, Path]) -> None:
    """Min-max rescale to uint8 and save as an image (base_utils.py:124-131)."""
    from PIL import Image

    pred_mask = np.asarray(pred_mask)
    rescaled = (
        255.0 / (pred_mask.max() + np.finfo(float).eps) * (pred_mask - pred_mask.min())
    ).astype(np.uint8)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rescaled).save(out_path)
    logger.info("saved %s to disk", out_path.name)


def make_logdir(
    root: Union[str, Path],
    dataset_name: str,
    lesion_type: str,
    exp_name: Optional[str] = None,
    now: Optional[datetime.datetime] = None,
) -> Path:
    """``models/<dataset>/<lesion>/<MonDD_HH_MM>/`` (reference pipeline.py:31-33)."""
    if exp_name is None:
        now = now or datetime.datetime.now()
        exp_name = now.strftime("%b%d_%H_%M")
    logdir = Path(root) / dataset_name / lesion_type / exp_name
    (logdir / "checkpoints").mkdir(parents=True, exist_ok=True)
    return logdir


def log_pretty_table(col_names: Sequence[str], row_data: Sequence[Sequence]) -> str:
    """ASCII table logger (base_utils.py:134-141) without the prettytable dep."""
    rows = [[str(c) for c in r] for r in row_data]
    widths = [max(len(str(c)), *(len(r[i]) for r in rows)) if rows else len(str(c))
              for i, c in enumerate(col_names)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(cells):
        return "|" + "|".join(f" {c:<{w}} " for c, w in zip(cells, widths)) + "|"
    lines = [sep, fmt([str(c) for c in col_names]), sep] + [fmt(r) for r in rows] + [sep]
    table = "\n".join(lines)
    logger.info("\n%s", table)
    return table
