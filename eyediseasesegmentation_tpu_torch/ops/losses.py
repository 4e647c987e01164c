"""Segmentation losses on logits (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/ops/losses.py``, name for name:
kl / topk / bce / wbce / log_bce / ce / soft_bce / focal / jaccard / lovasz /
symmetric_lovasz / log_jaccard / dice / log_dice, and ``compound_loss``.

Every loss is ``fn(logits, targets) -> scalar`` with logits and targets of
shape (B, C, H, W) (binary: C = 1); ``ce`` takes (B, K, H, W) logits and
integer (B, H, W) targets. Where the JAX package flattens channel-last, the
channel axis is moved last first, so the flattening order (and with it the
tie order of the Lovász sort) is the JAX package's. The trainer calls them
on fp32 logits.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-7
LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _channel_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1) if x.ndim == 4 else x


# ---------------------------------------------------------------------------
# BCE family
# ---------------------------------------------------------------------------

def _bce_with_logits(logits, targets, pos_weight=None):
    """Elementwise BCE-with-logits, numerically stable."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is None:
        return -(targets * log_p + (1.0 - targets) * log_not_p)
    return -(pos_weight * targets * log_p + (1.0 - targets) * log_not_p)


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def soft_bce_with_logits(logits, targets,
                         smooth_factor: Optional[float] = None,
                         ignore_index: Optional[float] = None,
                         pos_weight=None):
    """pytorch_toolbelt SoftBCEWithLogitsLoss: optional label smoothing and
    ignore mask."""
    mask = (None if ignore_index is None
            else (targets != ignore_index).to(logits.dtype))
    if smooth_factor is not None:
        soft = ((1.0 - targets) * smooth_factor
                + targets * (1.0 - smooth_factor))
    else:
        soft = targets
    return _masked_mean(_bce_with_logits(logits, soft, pos_weight), mask)


def weighted_bce_with_logits(logits, targets,
                             pos_weights: Sequence[float] = (1.0,),
                             ignore_index: Optional[float] = -100):
    """Reference WeightedBCEWithLogits: BCE with a per-channel pos_weight,
    the ignore mask multiplied in before the mean over all elements."""
    pw = torch.as_tensor(pos_weights, dtype=logits.dtype,
                         device=logits.device)
    if logits.ndim == 4:
        pw = pw.view(1, -1, 1, 1)
    loss = _bce_with_logits(logits, targets, pw)
    if ignore_index is not None:
        loss = loss * (targets != ignore_index).to(logits.dtype)
    return loss.mean()


def log_bce(logits, targets, smooth_factor: Optional[float] = 0.1,
            ignore_index: Optional[float] = None):
    """Reference LogBCE: class-frequency weighted BCE, beta = the per-image
    foreground frequency (no gradient), positives weighted (1 − beta)."""
    beta = targets.mean((2, 3), keepdim=True).detach()
    if smooth_factor is not None:
        soft = ((1.0 - targets) * smooth_factor
                + targets * (1.0 - smooth_factor))
    else:
        soft = targets
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    loss = -(1.0 - beta) * log_p * soft - beta * log_not_p * (1.0 - soft)
    if ignore_index is not None:
        loss = loss * (targets != ignore_index).to(loss.dtype)
    return loss.mean()


def topk_loss(logits, targets):
    """Reference TopKLoss: mean foreground BCE averaged with the mean of the
    |fg| hardest background BCEs."""
    loss = _bce_with_logits(logits, targets).reshape(-1)
    t = targets.reshape(-1)
    fg = (t == 1.0).to(loss.dtype)
    bg = t == 0.0
    n_fg = fg.sum()
    fg_mean = (loss * fg).sum() / torch.clamp(n_fg, min=1.0)
    bg_loss = torch.where(bg, loss, torch.full_like(loss, -float("inf")))
    # ascending stable sort, reversed (as jnp.sort(...)[::-1]): among equal
    # losses at the k-th rank the later pixels are taken first
    bg_sorted = torch.sort(bg_loss, stable=True).values.flip(0)
    ranks = torch.arange(bg_sorted.shape[0], device=loss.device)
    topk = (ranks < n_fg) & torch.isfinite(bg_sorted)
    kept = torch.where(topk, bg_sorted, torch.zeros_like(bg_sorted))
    topk_mean = kept.sum() / torch.clamp(topk.sum().to(loss.dtype), min=1.0)
    return 0.5 * fg_mean + 0.5 * topk_mean


def binary_focal_loss(logits, targets, gamma: float = 1.5,
                      alpha: Optional[float] = None,
                      ignore_index: Optional[float] = None):
    """pytorch_toolbelt BinaryFocalLoss(alpha=None, gamma=1.5)."""
    mask = (None if ignore_index is None
            else (targets != ignore_index).to(logits.dtype))
    logpt = -_bce_with_logits(logits, targets)
    pt = torch.exp(logpt)
    loss = -((1.0 - pt) ** gamma) * logpt
    if alpha is not None:
        loss = loss * (alpha * targets + (1.0 - alpha) * (1.0 - targets))
    return _masked_mean(loss, mask)


def kl_with_logits(logits, targets):
    """Reference KLDivLossWithLogits: KL between [t, 1 − t] and
    [sigmoid(x), sigmoid(−x)], mean over both channels (0·log 0 = 0)."""
    log_p = torch.stack([F.logsigmoid(logits), F.logsigmoid(-logits)], -1)
    t = torch.stack([targets, 1.0 - targets], -1)
    kl = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=EPS)) - log_p),
                     torch.zeros_like(log_p))
    return kl.mean()


def cross_entropy(logits, targets):
    """Multiclass CE: logits (B, K, H, W), integer targets (B, H, W)."""
    logp = F.log_softmax(logits, 1)
    onehot = F.one_hot(targets.long(), logits.shape[1]).movedim(-1, 1)
    return -(onehot.to(logp.dtype) * logp).sum(1).mean()


# ---------------------------------------------------------------------------
# Region losses (dice / jaccard)
# ---------------------------------------------------------------------------

def _soft_scores(logits, targets):
    """Binary-mode sums over batch and space, per channel."""
    c = logits.shape[1]
    p = _channel_last(torch.sigmoid(logits)).reshape(-1, c)
    t = _channel_last(targets).reshape(-1, c)
    inter = (p * t).sum(0)
    cardinality = (p + t).sum(0)
    return inter, cardinality, cardinality - inter, t.sum(0) > 0


def dice_loss(logits, targets, log_loss: bool = False, smooth: float = 0.0):
    """pytorch_toolbelt DiceLoss(mode='binary'): soft dice over the whole
    batch per channel; channels absent from the GT contribute 0."""
    inter, card, _, present = _soft_scores(logits, targets)
    dice = (2.0 * inter + smooth) / torch.clamp(card + smooth, min=EPS)
    loss = (-torch.log(torch.clamp(dice, min=EPS)) if log_loss
            else 1.0 - dice)
    return (loss * present.to(loss.dtype)).mean()


def jaccard_loss(logits, targets, log_loss: bool = False,
                 smooth: float = 0.0):
    inter, _, union, present = _soft_scores(logits, targets)
    jac = (inter + smooth) / torch.clamp(union + smooth, min=EPS)
    loss = (-torch.log(torch.clamp(jac, min=EPS)) if log_loss
            else 1.0 - jac)
    return (loss * present.to(loss.dtype)).mean()


# ---------------------------------------------------------------------------
# Lovász hinge (Berman et al.)
# ---------------------------------------------------------------------------

def _lovasz_grad(gt_sorted):
    """Gradient of the Lovász extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=EPS)
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def _lovasz_hinge_flat(logits, labels):
    """Lovász hinge on flat logits and {0, 1} labels. The errors are sorted
    descending with a stable sort (equal errors keep their order, as
    ``jnp.argsort`` keeps them); the hinge is elu(errors) + 1."""
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    order = torch.argsort(-errors, stable=True)
    grad = _lovasz_grad(labels[order]).detach()
    return ((F.elu(errors[order]) + 1.0) * grad).sum()


def _per_image(logits, targets):
    b = logits.shape[0]
    return (_channel_last(logits).reshape(b, -1),
            _channel_last(targets).reshape(b, -1))


def lovasz_hinge(logits, targets, per_image: bool = False):
    """Binary Lovász hinge over the whole batch (reference
    BinaryLovaszLoss(per_image=False)), or the mean over images."""
    lg, tg = _per_image(logits, targets)
    if per_image:
        return torch.stack([_lovasz_hinge_flat(a, b)
                            for a, b in zip(lg, tg)]).mean()
    return _lovasz_hinge_flat(lg.reshape(-1), tg.reshape(-1))


def symmetric_lovasz(logits, targets):
    """Reference SymmetricLovasz: per-image Lovász on (x, t) and
    (−x, 1 − t), averaged."""
    return 0.5 * (lovasz_hinge(logits, targets, per_image=True)
                  + lovasz_hinge(-logits, 1.0 - targets, per_image=True))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def get_loss(loss_name: str, ignore_index=None,
             pos_weights: Sequence[float] = (1.0,)) -> LossFn:
    name = loss_name.lower()
    table = {
        "kl": kl_with_logits,
        "topk": topk_loss,
        # no pos_weights: only "wbce" reads them
        "bce": functools.partial(soft_bce_with_logits,
                                 ignore_index=ignore_index),
        "wbce": functools.partial(
            weighted_bce_with_logits, pos_weights=pos_weights,
            ignore_index=ignore_index if ignore_index is not None else -100),
        "log_bce": functools.partial(log_bce, ignore_index=ignore_index),
        "ce": cross_entropy,
        "soft_bce": functools.partial(soft_bce_with_logits,
                                      smooth_factor=0.1,
                                      ignore_index=ignore_index),
        "focal": functools.partial(binary_focal_loss, gamma=1.5, alpha=None,
                                   ignore_index=ignore_index),
        "jaccard": jaccard_loss,
        "log_jaccard": functools.partial(jaccard_loss, log_loss=True),
        "dice": dice_loss,
        "log_dice": functools.partial(dice_loss, log_loss=True),
        "lovasz": lovasz_hinge,
        "symmetric_lovasz": symmetric_lovasz,
    }
    if name not in table:
        raise KeyError(f"Unknown loss '{loss_name}'. Options: {sorted(table)}")
    return table[name]


def compound_loss(criterion: Dict[str, float], ignore_index=None,
                  pos_weights: Sequence[float] = (1.0,)):
    """Weighted sum over the registry from a criterion dict such as
    ``{'bce': 0.8, 'log_dice': 0.2}``. Returns ``fn(logits, targets) ->
    (total, {name: term})``."""
    terms = {name: get_loss(name, ignore_index, pos_weights)
             for name in criterion}

    def fn(logits, targets):
        parts = {name: terms[name](logits, targets) for name in terms}
        total = sum(criterion[name] * parts[name] for name in terms)
        return total, parts

    return fn
