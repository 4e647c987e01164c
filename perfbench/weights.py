"""Weights from the seed, made on the device in two large draws.

Every leaf of the reference model gets a slice of one normal and one
uniform draw of a ``torch.Generator`` on the device, shifted and scaled by
its kind, at the scales of the program's random initialisation (fan-in
normal kernels, unit-normal axial position tables, BatchNorm statistics and
affines drawn away from the identity, so that eval-mode norms are not the
identity). The same tensors are loaded into the program's model and the
reference's, so neither side makes weights of its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn


# (distribution, a, b): "normal" → a + b·z, "uniform" → a + (b − a)·u
Rule = Tuple[str, float, float]


def leaf_rules(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], Rule]]:
    """(state-dict name, shape, rule) of every persistent leaf, in the
    state dict's order; raises on a leaf no kind covers. A leaf's kind is
    read from its module: a norm (running statistics), a convolution or
    linear layer, a relative-position table (``relative``) or an attention
    projection (``to_qkv``, ``to_kq``, ``to_v``)."""
    rules: Dict[str, Rule] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(getattr(mod, "running_mean", None), torch.Tensor):
            rules.update({pre + "weight": ("uniform", 0.8, 1.2),
                          pre + "bias": ("normal", 0.0, 0.1),
                          pre + "running_mean": ("normal", 0.0, 0.1),
                          pre + "running_var": ("uniform", 0.5, 1.5)})
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            rules[pre + "weight"] = ("normal", 0.0,
                                     mod.weight[0].numel() ** -0.5)
            if mod.bias is not None:
                rules[pre + "bias"] = ("normal", 0.0, 0.01)
        elif isinstance(getattr(mod, "relative", None), nn.Parameter):
            rules[pre + "relative"] = ("normal", 0.0, 1.0)
        for leaf in ("to_qkv", "to_kq", "to_v"):
            p = getattr(mod, leaf, None)
            if isinstance(p, nn.Parameter):
                rules[pre + leaf] = ("normal", 0.0, p.shape[0] ** -0.5)
    out = []
    for name, t in model.state_dict().items():
        if name not in rules:
            raise ValueError(f"no weight rule for {name}")
        out.append((name, tuple(t.shape), rules[name]))
    return out


def make_weights(model: nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` drawn from ``seed`` on ``device``
    (float32): one normal and one uniform draw of the whole size, sliced."""
    rules = leaf_rules(model)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in rules]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, (kind, a, b)), n in zip(rules, sizes):
        if kind == "normal":
            t = z[off:off + n] * b + a
        else:
            t = u[off:off + n] * (b - a) + a
        out[name] = t.reshape(shape).clone()
        off += n
    return out
