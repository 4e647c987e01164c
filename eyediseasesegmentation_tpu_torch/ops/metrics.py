"""Segmentation metrics on torch tensors, computed on the tensor's device.

Counterpart of ``eyediseasesegmentation_tpu/ops/metrics.py``, function for
function:

* ``average_precision``: exact ``sklearn.metrics.average_precision_score``
  through the tie-block identity, so the order of equal scores after the
  (unstable) sort does not matter;
* ``roc_auc``: exact ``sklearn.metrics.roc_auc_score`` through tie-averaged
  ranks;
* ``threshold_sweep``: the 19-threshold TP / AP / PP / TN counts;
* ``batch_image_metrics``: per-image AP (or ROC-AUC) and the sweep of a
  padded batch, summed over its valid images;
* ``dice_coeff`` / ``iou_coeff`` at 0.5, the curve helpers, the three
  optimal thresholds and ``per_image_stats``.

Counts are fp32, as in the JAX package. ``threshold_sweep`` counts each
threshold's pixels by bucketing every pixel once against the 19 thresholds
(``torch.bucketize`` + ``torch.bincount``) instead of building the JAX
package's (19, N) fp32 mask: the counts are the same integers (one image's
counts stay below 2^24, where fp32 is exact), and the peak memory is O(N)
instead of 19·N·4 bytes (0.93 GB for one 2848×4288 image). Across images
they add in fp32, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

EPS = 1e-7

# The fixed sweep of plot_aucpr_curve (reference aucpr.py:53).
THRESH_LIST = np.array(
    [0, 0.00001, 0.0001, 0.001, 0.01, 0.1, 0.2, 0.3, 0.4, 0.5,
     0.6, 0.7, 0.8, 0.9, 0.99, 0.999, 0.9999, 0.99999, 1],
    dtype=np.float32,
)


def _thresholds(thresholds, device) -> torch.Tensor:
    if thresholds is None:
        thresholds = THRESH_LIST
    return torch.as_tensor(thresholds, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Hard dice / iou @ threshold (train-time callbacks)
# ---------------------------------------------------------------------------

def _hard_counts(probs, targets, threshold=0.5):
    pred = (probs > threshold).float()
    t = (targets > 0.5).float()
    inter = torch.sum(pred * t)
    return inter, torch.sum(pred), torch.sum(t)


def dice_coeff(probs, targets, threshold: float = 0.5, eps: float = EPS):
    inter, p, t = _hard_counts(probs, targets, threshold)
    return (2.0 * inter + eps) / (p + t + eps)


def iou_coeff(probs, targets, threshold: float = 0.5, eps: float = EPS):
    inter, p, t = _hard_counts(probs, targets, threshold)
    return (inter + eps) / (p + t - inter + eps)


# ---------------------------------------------------------------------------
# Exact average precision and ROC-AUC
# ---------------------------------------------------------------------------

def _block_end_index(boundary: torch.Tensor) -> torch.Tensor:
    """For each position, the index of the end of its tie-block:
    ``boundary[i]`` is True at the last element of each block (sorted
    order), and the result is a reverse cumulative minimum over
    (i where boundary, else n − 1)."""
    n = boundary.shape[0]
    idx = torch.arange(n, device=boundary.device)
    cand = torch.where(boundary, idx, torch.full_like(idx, n - 1))
    return torch.cummin(cand.flip(0), 0).values.flip(0)


def _sorted(scores, labels, descending: bool):
    s = scores.reshape(-1).float()
    y = labels.reshape(-1).float()
    order = torch.argsort(s, descending=descending)
    return s[order], y[order]


def average_precision(scores: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Exact AP = Σ_n (R_n − R_{n−1}) · P_n over distinct-threshold points,
    as (1/P) Σ over positives of the precision at the end of their
    tie-block."""
    s, y = _sorted(scores, labels, descending=True)
    n = s.shape[0]
    tps = torch.cumsum(y, 0)
    precision = tps / (torch.arange(n, dtype=torch.float32,
                                    device=s.device) + 1.0)
    boundary = torch.cat([s[:-1] != s[1:],
                          torch.ones(1, dtype=torch.bool, device=s.device)])
    pe = precision[_block_end_index(boundary)]
    total_pos = torch.clamp(tps[-1], min=1.0)
    return torch.sum(y * pe) / total_pos


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact ROC-AUC via the Mann-Whitney statistic with tie-averaged
    ranks."""
    s, y = _sorted(scores, labels, descending=False)
    n = s.shape[0]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    end_idx = _block_end_index(torch.cat([s[:-1] != s[1:], one])).float()
    idx = torch.arange(n, device=s.device)
    cand = torch.where(torch.cat([one, s[1:] != s[:-1]]), idx,
                       torch.zeros_like(idx))
    start_idx = torch.cummax(cand, 0).values.float()
    ranks = (start_idx + end_idx) / 2.0 + 1.0
    pos = torch.sum(y)
    neg = n - pos
    rank_sum = torch.sum(ranks * y)
    return ((rank_sum - pos * (pos + 1.0) / 2.0)
            / torch.clamp(pos * neg, min=1.0))


# ---------------------------------------------------------------------------
# Threshold sweep
# ---------------------------------------------------------------------------

def threshold_sweep(probs: torch.Tensor, targets: torch.Tensor,
                    thresholds=None, valid_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Per-threshold (TP, AP, PP, TN) fp32 counts of one image, with the
    strict ``pred > threshold`` of aucpr.py:64; pixels where ``valid_mask``
    is 0 are left out. Sum the arrays to accumulate across images."""
    th = _thresholds(thresholds, probs.device)
    k = th.shape[0]
    p = probs.reshape(-1).float()
    t = (targets.reshape(-1) > 0.5).long()
    # bucket b = #{thresholds below p}: p > th_j exactly for j < b (NaN is
    # above no threshold)
    b = torch.bucketize(p, th, right=False)
    b = torch.where(torch.isnan(p), torch.zeros_like(b), b)
    key = b + (k + 1) * t
    if valid_mask is not None:
        key = torch.where(valid_mask.reshape(-1) != 0, key,
                          torch.full_like(key, 2 * (k + 1)))
    hist = torch.bincount(key, minlength=2 * (k + 1) + 1)
    neg, pos = hist[:k + 1], hist[k + 1:2 * (k + 1)]
    # pixels above threshold j: buckets j + 1 .. k
    above = lambda h: torch.flip(torch.cumsum(torch.flip(h, [0]), 0),
                                 [0])[1:]
    tp = above(pos)
    pp = above(pos + neg)
    tn = torch.cumsum(neg, 0)[:k]
    ap = pos.sum().expand(k)
    return tuple(c.float() for c in (tp, ap, pp, tn))


def batch_image_metrics(probs: torch.Tensor, masks: torch.Tensor,
                        valid: Union[None, int, torch.Tensor] = None,
                        score: str = "ap") -> Dict[str, torch.Tensor]:
    """Per-image AP (``score='ap'``, the lesion path) or ROC-AUC ('roc',
    vessels) and the 19-threshold sweep of a (B, H, W) batch, summed over
    its valid images. ``valid``: (B,) bool, or the number of leading real
    images (the rest is batch padding). Images whose GT is empty are left
    out of the AP mean, as in the reference (aucpr.py:22-23). Accumulate
    across batches by adding each entry."""
    probs = probs.float()
    masks = masks.float()   # masks may arrive uint8
    bsz = probs.shape[0]
    if valid is None:
        valid = torch.ones(bsz, dtype=torch.bool, device=probs.device)
    elif not isinstance(valid, torch.Tensor) or valid.ndim == 0:
        valid = torch.arange(bsz, device=probs.device) < int(valid)
    valid = valid.to(probs.device)
    valid_f = valid.float()
    fn = average_precision if score == "ap" else roc_auc
    per_img = torch.stack([fn(probs[i], masks[i]) for i in range(bsz)])
    has_pos = (torch.sum(masks, dim=(1, 2)) > 0) & valid
    tp, ap, pp, tn = (torch.stack(c) for c in zip(
        *(threshold_sweep(probs[i], masks[i]) for i in range(bsz))))
    w = valid_f[:, None]
    px_per_img = float(np.prod(probs.shape[1:]))
    return {
        "ap_sum": torch.sum(torch.where(has_pos, per_img,
                                        torch.zeros_like(per_img))),
        "ap_count": torch.sum(has_pos.float()),
        "tp": torch.sum(tp * w, 0), "ap": torch.sum(ap * w, 0),
        "pp": torch.sum(pp * w, 0), "tn": torch.sum(tn * w, 0),
        "px": torch.sum(valid_f) * px_per_img,
    }


def pr_from_counts(tp, ap, pp):
    """Sensitivity / PPV with the 1e-7 smoothing of aucpr.py:83-86."""
    sn = (tp + 1e-7) / (ap + 1e-7)
    ppv = (tp + 1e-7) / (pp + 1e-7)
    return sn, ppv


def roc_from_counts(tp, ap, tn, total, eps=1e-7):
    """Sensitivity / false-positive rate (for plot_aucroc_curve)."""
    an = total - ap
    sn = (tp + eps) / (ap + eps)
    fpr = ((an - tn) + eps) / (an + eps)
    return sn, fpr


def auc_trapezoid(x, y):
    """sklearn.metrics.auc: the trapezoid area along the curve in its given
    order, negated when x decreases."""
    area = torch.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1]) / 2.0)
    return torch.where(x[-1] < x[0], -area, area)


def optimal_thresholds(sn, ppv, thresholds=None):
    """The three optimal-threshold rules of aucpr.py:90-98: min |P − R|, min
    distance to (1, 1), max F-score. Returns (t0, t1, t2)."""
    th = _thresholds(thresholds, sn.device)
    f_score = (2.0 * sn * ppv) / (sn + ppv)
    t0 = th[torch.argmin(torch.abs(ppv - sn))]
    t1 = th[torch.argmin(torch.sqrt((1.0 - ppv) ** 2 + (1.0 - sn) ** 2))]
    t2 = th[torch.argmax(f_score)]
    return t0, t1, t2


# ---------------------------------------------------------------------------
# Per-image statistics (reference stat_result.py:54-88 conventions)
# ---------------------------------------------------------------------------

def per_image_stats(pred_bin: torch.Tensor, gt_bin: torch.Tensor,
                    eps: float = 1e-12) -> Dict[str, torch.Tensor]:
    """SN / PPV / SP / IoU / Dice of one binary mask pair; a ratio with a
    zero denominator is 1, as in the reference."""
    pred = (pred_bin > 0.5).float()
    gt = (gt_bin > 0.5).float()
    tp = torch.sum(pred * gt)
    fp = torch.sum(pred * (1 - gt))
    fn = torch.sum((1 - pred) * gt)
    tn = torch.sum((1 - pred) * (1 - gt))

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=eps),
                           torch.ones_like(den))

    return {"sn": ratio(tp, tp + fn), "ppv": ratio(tp, tp + fp),
            "sp": ratio(tn, tn + fp), "iou": ratio(tp, tp + fp + fn),
            "dice": ratio(2 * tp, 2 * tp + fp + fn)}
