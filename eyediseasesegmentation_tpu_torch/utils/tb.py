"""TensorBoard event writer behind the metrics.jsonl stream (torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/tb.py``: the trainer's
canonical metric stream is ``metrics.jsonl``; this mirrors it into event
files through ``torch.utils.tensorboard.SummaryWriter``, imported lazily.
When that import fails (no ``tensorboard`` package) the writer is a no-op
with one warning. This is logging, not the compute path.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


class TensorBoardWriter:
    """Scalar writer: ``add_scalars(step, {"train/loss": 0.3, ...})``."""

    def __init__(self, logdir, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=str(Path(logdir)))
        except Exception as e:  # tensorboard missing or broken
            logger.warning("TensorBoard writer disabled: %s", e)

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        if self._writer is None:
            return
        for tag, value in scalars.items():
            try:
                self._writer.add_scalar(tag, float(value), global_step=step)
            except (TypeError, ValueError):
                pass  # non-numeric rows stay in metrics.jsonl only

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def row_to_scalars(row: Dict) -> Dict[str, float]:
    """A metrics.jsonl row as TB tags: train_* / val_* become groups,
    lr and time stay top-level, epoch is the step."""
    out = {}
    for k, v in row.items():
        if not isinstance(v, (int, float)):
            continue
        if k.startswith("train_"):
            out["train/" + k[6:]] = v
        elif k.startswith("val_"):
            out["val/" + k[4:]] = v
        elif k != "epoch":
            out[k] = v
    return out
