"""PR / ROC curve reports from device-accumulated counts (torch port).

A copy of ``eyediseasesegmentation_tpu/analysis/aucpr.py``, on numpy. The
host-side tail of the metric pipeline (reference ``src/main/aucpr.py``): the
19-threshold TP/AP/PP(/TN) counts come from the on-device vectorized sweep
(``ops.metrics.threshold_sweep``); this module computes sensitivity/PPV with the
reference's 1e-7 smoothing (aucpr.py:83-86), the AUC, the three optimal
thresholds (aucpr.py:90-98), and writes the curve figure (matplotlib instead of
plotly+orca — same jpg artifact contract, aucpr.py:103-116).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..ops.metrics import THRESH_LIST

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


def _save_curve(x, y, title, xlabel, ylabel, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.fill_between(x, y, alpha=0.25)
    ax.plot(x, y, marker=".")
    ax.plot([0, 1], [1, 0], linestyle="--", color="gray", linewidth=1)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title, fontsize=9)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def pr_curve_report(tp: np.ndarray, ap: np.ndarray, pp: np.ndarray,
                    exp_name: str, figure_dir: Optional[Path] = None
                    ) -> Dict[str, float]:
    """Return the three optimal thresholds + AUC-PR; optionally save the figure."""
    thresh = np.asarray(THRESH_LIST, dtype=float)
    sn = (tp + 1e-7) / (ap + 1e-7)          # recall  (aucpr.py:83-84)
    ppv = (tp + 1e-7) / (pp + 1e-7)         # precision
    f_score = (2 * sn * ppv) / (sn + ppv)
    # sklearn.metrics.auc over (recall, precision) in threshold order
    aucpr = float(np.trapezoid(ppv[::-1], sn[::-1]))
    t0 = float(thresh[np.argmin(np.abs(ppv - sn))])
    t1 = float(thresh[np.argmin(np.sqrt((1 - ppv) ** 2 + (1 - sn) ** 2))])
    t2 = float(thresh[np.argmax(f_score)])
    logger.info("OPTIMAL THRESHOLD: %s / %s / %s (AUC-PR %.5f)", t0, t1, t2, aucpr)
    if figure_dir is not None:
        _save_curve(sn, ppv,
                    f"Precision-Recall Curve AUC:{aucpr:.5f} - Optimal threshold: {t2}",
                    "Recall", "Precision",
                    Path(figure_dir) / f"{exp_name}.jpg")
    return {"optimal_threshold": t0, "optimal_threshold_1": t1,
            "optimal_threshold_2": t2, "aucpr": aucpr}


def roc_curve_report(tp: np.ndarray, ap: np.ndarray, tn: np.ndarray,
                     total_pixels: float, exp_name: str,
                     figure_dir: Optional[Path] = None,
                     pp: Optional[np.ndarray] = None) -> Dict[str, float]:
    """ROC counterpart for the vessel pipeline (reference aucpr.py:120-205).

    Reference-exact math: SN and SP are the 1e-7-smoothed ratios, FPR = 1-SP,
    AUC is the trapezoid over (FPR, TPR), and the reference's single optimal
    threshold is the **F-score argmax** over the smoothed (TPR, PPV) pair
    (aucpr.py:185-187) — returned in BOTH the 'optimal_threshold' and the
    'optimal_threshold_2' slot that downstream binarization consumes.  The
    Youden-J threshold is kept as 'optimal_threshold_1' (an extension; the
    reference returns one value)."""
    thresh = np.asarray(THRESH_LIST, dtype=float)
    an = total_pixels - ap
    sn = (tp + 1e-7) / (ap + 1e-7)
    sp = (tn + 1e-7) / (an + 1e-7)
    fpr = 1.0 - sp
    aucroc = float(np.trapezoid(sn[::-1], fpr[::-1]))
    t1 = float(thresh[np.argmax(sn - fpr)])  # Youden J (extension)
    if pp is not None:
        ppv = (tp + 1e-7) / (pp + 1e-7)
        f_score = (2 * sn * ppv) / (sn + ppv)
        t2 = float(thresh[np.argmax(f_score)])
    else:  # legacy callers without predicted-positive counts
        t2 = float(thresh[np.argmax(np.sqrt(sn * sp))])
    t0 = t2
    logger.info("OPTIMAL ROC THRESHOLD: %s / %s / %s (AUC-ROC %.5f)",
                t0, t1, t2, aucroc)
    if figure_dir is not None:
        _save_curve(fpr, sn,
                    f"ROC Curve AUC:{aucroc:.5f} - Optimal threshold: {t2}",
                    "False positive rate", "Sensitivity",
                    Path(figure_dir) / f"{exp_name}_roc.jpg")
    return {"optimal_threshold": t0, "optimal_threshold_1": t1,
            "optimal_threshold_2": t2, "aucroc": aucroc}
