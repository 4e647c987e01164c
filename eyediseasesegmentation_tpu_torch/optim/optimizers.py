"""Optimizer registry (torch.optim, with optax's semantics).

Counterpart of ``eyediseasesegmentation_tpu/optim/optimizers.py`` for
``adamw`` (the default), ``adam`` (weight decay coupled into the gradient)
and ``sgd`` (Nesterov, momentum 0.9, coupled weight decay). The default
``eps`` is 1e-5, the JAX package's, not torch's 1e-8.

Parameter groups carry the JAX package's ``lr_scale_fn`` and weight-decay
mask: a group's ``lr_mult`` scales its whole update, weight decay included,
as ``_with_lr_scales`` scales the optax update (for these three optimizers
the update is linear in the learning rate, so a group learning rate of
``lr_mult · lr`` is the same thing), and a masked group has weight decay 0.
The learning rate is set per step with :func:`set_learning_rate`, the role
of ``optax.inject_hyperparams``.

``rms``, ``radam``, ``ranger``, ``lamb``, ``diffgrad``, ``novograd``,
``madgrad`` and the ``_lookahead`` wrapper are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

NOT_PORTED = ("rms", "radam", "ranger", "lamb", "diffgrad", "novograd",
              "madgrad")


def get_optimizer(optimizer_name: str, groups: List[Dict[str, Any]],
                  learning_rate: float, eps: float = 1e-5
                  ) -> torch.optim.Optimizer:
    """Build an optimizer by name over ``groups`` (from
    ``train.param_groups.param_groups``: each with ``params``,
    ``lr_mult`` and ``weight_decay``)."""
    name = optimizer_name.lower()
    if name.endswith("_lookahead") or name in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer '{optimizer_name}' is not ported yet (ported: adamw, "
            "adam, sgd); the rest: ROADMAP.md queue 1 item E")
    groups = [dict(g, lr=learning_rate * g["lr_mult"]) for g in groups]
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=eps)
    if name == "adam":
        return torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999),
                                eps=eps)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=learning_rate, momentum=0.9,
                               nesterov=True)
    raise KeyError(f"Unknown optimizer '{optimizer_name}'")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the base learning rate: each group's is ``lr_mult · lr``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
