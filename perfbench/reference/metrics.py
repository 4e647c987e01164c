"""Plain reference of the per-image scores and the threshold sweep.

Written from the definitions, in float64: average precision as
scikit-learn's ``average_precision_score`` (Σ (R_n − R_{n−1})·P_n over the
distinct scores), ROC-AUC as the trapezoid under the (FPR, TPR) points of
the distinct scores, and the 19-threshold counts ``p > t`` one threshold
at a time. A batch's totals: the score summed over the valid images whose
ground truth has a positive pixel (and their count), the sweep counts
summed over the valid images, and their pixel count.
"""

from __future__ import annotations

from typing import Dict

import torch

THRESHOLDS = (0, 0.00001, 0.0001, 0.001, 0.01, 0.1, 0.2, 0.3, 0.4, 0.5,
              0.6, 0.7, 0.8, 0.9, 0.99, 0.999, 0.9999, 0.99999, 1)


def _curve(scores: torch.Tensor, labels: torch.Tensor):
    """Cumulative (TP, FP) at the end of each block of equal scores, in
    descending order of score."""
    s, order = torch.sort(scores.reshape(-1).double(), descending=True)
    y = labels.reshape(-1).double()[order]
    ends = torch.nonzero(torch.cat([s[1:] != s[:-1],
                                    s.new_ones(1, dtype=torch.bool)]))[:, 0]
    tps = torch.cumsum(y, 0)[ends]
    fps = (ends + 1).double() - tps
    return tps, fps


def average_precision(scores, labels) -> torch.Tensor:
    tps, fps = _curve(scores, labels)
    pos = tps[-1].clamp(min=1.0)
    recall_step = torch.diff(tps, prepend=tps.new_zeros(1)) / pos
    return torch.sum(recall_step * tps / (tps + fps))


def roc_auc(scores, labels) -> torch.Tensor:
    tps, fps = _curve(scores, labels)
    tpr = torch.cat([tps.new_zeros(1), tps / tps[-1].clamp(min=1.0)])
    fpr = torch.cat([fps.new_zeros(1), fps / fps[-1].clamp(min=1.0)])
    return torch.trapezoid(tpr, fpr)


def sweep(probs: torch.Tensor,
          labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    p = probs.reshape(-1).float()
    y = labels.reshape(-1)
    out = {"tp": [], "pp": [], "tn": []}
    for t in THRESHOLDS:
        above = p > t
        out["tp"].append((above & y).sum())
        out["pp"].append(above.sum())
        out["tn"].append((~above & ~y).sum())
    res = {k: torch.stack(v).double() for k, v in out.items()}
    res["ap"] = y.sum().double().expand(len(THRESHOLDS))
    return res


def batch_totals(probs: torch.Tensor, masks: torch.Tensor, n_valid: int,
                 score: str = "ap") -> Dict[str, torch.Tensor]:
    """Totals of the first ``n_valid`` images of a (B, H, W) batch."""
    fn = average_precision if score == "ap" else roc_auc
    tot: Dict[str, torch.Tensor] = {}
    score_sum = torch.zeros((), dtype=torch.float64, device=probs.device)
    count = 0
    for i in range(n_valid):
        y = masks[i] > 0.5
        if bool(y.any()):
            score_sum = score_sum + fn(probs[i], y)
            count += 1
        for k, v in sweep(probs[i], y).items():
            tot[k] = tot[k] + v if k in tot else v
    tot["ap_sum"] = score_sum
    tot["ap_count"] = torch.tensor(float(count), dtype=torch.float64)
    tot["px"] = torch.tensor(float(n_valid * probs[0].numel()),
                             dtype=torch.float64)
    return tot
