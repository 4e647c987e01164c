"""Differential learning-rate / weight-decay groups (torch port).

Counterpart of ``eyediseasesegmentation_tpu/train/param_groups.py`` (the
reference's ``get_paramgroup``, unetplusplusstar.py:496-517): relative
position tables (``pos_enc``) get lr × 1 and weight decay 0; the pretrained
encoder part (``encoder`` but not ``layer4``) lr × 0.1; the rest lr × 1.
The port's parameter names mirror the flax scopes, so the rule reads the
same substrings of the dotted names as the JAX rule reads of its paths.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def lr_scale_fn_for(model_name: str
                    ) -> Optional[Callable[[str], Tuple[float, float]]]:
    """name → (lr_mult, wd_mult), or None when no groups apply."""
    if model_name != "unetplusplusstar":
        return None

    def scale(name: str) -> Tuple[float, float]:
        if "pos_enc" in name:
            return 1.0, 0.0
        if "encoder" in name and "layer4" not in name:
            return 0.1, 1.0
        return 1.0, 1.0

    return scale


def param_groups(model: torch.nn.Module, model_name: str,
                 weight_decay: float,
                 frozen_prefixes: Sequence[str] = ()) -> List[Dict[str, Any]]:
    """The optimizer's groups: parameters of one (lr_mult, wd_mult) in one
    group, ``weight_decay`` where wd_mult > 0 and 0 where the mask zeroes
    it, in the model's parameter order; ``weight_decay_unmasked`` holds the
    decay for the optimizers the JAX registry builds without the mask
    (``diffgrad``, ``novograd``, ``madgrad``). Parameters under
    ``frozen_prefixes`` are left out and stop requiring grad, so neither
    they nor an optimizer state of theirs ever move."""
    scale = lr_scale_fn_for(model_name) or (lambda name: (1.0, 1.0))
    groups: Dict[Tuple[float, float], Dict[str, Any]] = {}
    for name, p in model.named_parameters():
        if any(name.startswith(f + ".") for f in frozen_prefixes):
            p.requires_grad_(False)
            continue
        lr_mult, wd_mult = scale(name)
        g = groups.setdefault((lr_mult, wd_mult), {
            "params": [], "names": [], "lr_mult": lr_mult,
            "weight_decay": weight_decay if wd_mult > 0 else 0.0,
            "weight_decay_unmasked": weight_decay})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())
