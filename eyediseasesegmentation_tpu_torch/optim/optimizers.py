"""Optimizer registry (torch.optim, with optax's semantics).

Counterpart of ``eyediseasesegmentation_tpu/optim/optimizers.py``: ``sgd``,
``adam``, ``rms``, ``adamw``, ``radam``, ``ranger``, ``lamb``,
``diffgrad``, ``novograd`` and ``madgrad``, each also with a
``_lookahead`` suffix (the suffix is read as the JAX registry reads it:
``name.split("_")[1] == "lookahead"``). The default ``eps`` is 1e-5, the
JAX package's, not torch's 1e-8.

Parameter groups carry the JAX package's ``lr_scale_fn`` and weight-decay
mask: a group's ``lr_mult`` scales its whole update, weight decay included,
as ``_with_lr_scales`` scales the optax update, and a masked group has
weight decay 0. ``adamw``, ``adam`` and ``sgd`` without lookahead are
torch's own classes: their update is linear in the learning rate, so a
group learning rate of ``lr_mult · lr`` is the same thing. Every other name
runs :class:`OptaxOptimizer`, which computes the optax update at the base
rate and then scales it by ``lr_mult`` (MADGRAD's update is not linear in
the rate). As in the JAX registry, ``diffgrad``, ``novograd`` and
``madgrad`` decay every parameter, the masked ones too (their groups'
``weight_decay_unmasked``).

The learning rate is set per step with :func:`set_learning_rate`, the role
of ``optax.inject_hyperparams``. Every counter of :class:`OptaxOptimizer`
(the step, which also drives the lookahead sync and MADGRAD's λ) is a 0-d
CPU tensor in each parameter's state, as torch keeps its own ``step``, so
``train.checkpoint.resume_state`` / ``restore_into`` resume a run exactly;
``OPTAX_FIELDS`` / :func:`state_fields` name the optax state each state key
comes from, so ``restore_into`` also resumes from a JAX ``best_full.ckpt``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

NAMES = ("sgd", "adam", "rms", "adamw", "radam", "ranger", "lamb",
         "diffgrad", "novograd", "madgrad")
# torch's classes, exact with a group learning rate of lr_mult · lr
TORCH_CLASSES = ("adamw", "adam", "sgd")
# the names the JAX registry builds without the weight-decay mask
UNMASKED = ("diffgrad", "novograd", "madgrad")
B1, B2 = 0.9, 0.999
SYNC_PERIOD, SLOW_STEP = 5, 0.5        # the lookahead wrapper's


def parse_name(optimizer_name: str) -> Tuple[str, bool]:
    """(base name, lookahead) as the JAX registry parses a name."""
    parts = optimizer_name.split("_")
    if len(parts) > 1 and parts[1] == "lookahead":
        return parts[0].lower(), True
    return optimizer_name.lower(), False


def get_optimizer(optimizer_name: str, groups: List[Dict[str, Any]],
                  learning_rate: float, eps: float = 1e-5
                  ) -> torch.optim.Optimizer:
    """Build an optimizer by name over ``groups`` (from
    ``train.param_groups.param_groups``: each with ``params``,
    ``lr_mult`` and ``weight_decay``, and ``weight_decay_unmasked`` for
    the names that ignore the mask; without it the group's
    ``weight_decay`` is used)."""
    name, lookahead = parse_name(optimizer_name)
    if name not in NAMES:
        raise KeyError(f"Unknown optimizer '{optimizer_name}'")
    groups = [dict(g, lr=learning_rate * g["lr_mult"], base_lr=learning_rate)
              for g in groups]
    if lookahead or name not in TORCH_CLASSES:
        return OptaxOptimizer(groups, name, lookahead=lookahead, eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=learning_rate, betas=(B1, B2),
                                 eps=eps)
    if name == "adam":
        return torch.optim.Adam(groups, lr=learning_rate, betas=(B1, B2),
                                eps=eps)
    return torch.optim.SGD(groups, lr=learning_rate, momentum=0.9,
                           nesterov=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the base learning rate: each group's is ``lr_mult · lr``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
        group["base_lr"] = lr


# ---------------------------------------------------------------------------
# The optax updates, one parameter at a time. Each returns the update (the
# change of the parameter) at the base learning rate ``lr``; ``k`` is the
# step count after this step's increment (optax's ``count_inc``). The
# scalars that depend on the count are computed in float32 as optax computes
# them: 1 − 0.999^k loses most of its digits there, which moves RAdam's ρ_t
# by up to 0.05 and its rectification factor by 1-2 %.
# ---------------------------------------------------------------------------

def _pow32(b: float, k: int) -> np.float32:
    """``b ** count`` in float32 as XLA computes it in a jitted update: the
    float32 ``b`` raised to ``k``, rounded once to float32."""
    return np.float32(np.float64(np.float32(b)) ** k)


def _bias(b: float, k: int) -> float:
    """optax's ``bias_correction`` denominator 1 − b^k, in float32."""
    return float(np.float32(1.0) - _pow32(b, k))


def _decayed(g, p, wd):
    """``optax.add_decayed_weights``."""
    return g + wd * p if wd else g


def _moments(st, g):
    """optax's ``update_moment`` (order 1) and ``update_moment_per_elem_norm``
    (order 2) with b1 0.9, b2 0.999."""
    m = st["exp_avg"].mul_(B1).add_(g, alpha=1 - B1)
    v = st["exp_avg_sq"].mul_(B2).add_(g * g, alpha=1 - B2)
    return m, v


def _adam_scale(st, g, k, eps):
    """``optax.scale_by_adam``: bias-corrected m / (√v + eps)."""
    m, v = _moments(st, g)
    return (m / _bias(B1, k)) / ((v / _bias(B2, k)).sqrt() + eps)


def _sgd(st, p, g, k, lr, wd, eps):
    g = _decayed(g, p, wd)
    tr = st["momentum_buffer"].mul_(0.9).add_(g)       # trace, nesterov
    return (g + 0.9 * tr) * -lr


def _adam(st, p, g, k, lr, wd, eps):
    return _adam_scale(st, _decayed(g, p, wd), k, eps) * -lr


def _adamw(st, p, g, k, lr, wd, eps):
    return _decayed(_adam_scale(st, g, k, eps), p, wd) * -lr


def _rms(st, p, g, k, lr, wd, eps):
    """``optax.rmsprop(lr)``: decay 0.9, eps 1e-8 inside the square root,
    initial scale 0 (the registry's ``eps`` does not reach it)."""
    g = _decayed(g, p, wd)
    nu = st["square_avg"].mul_(0.9).add_(g * g, alpha=0.1)
    return g * torch.rsqrt(nu + 1e-8) * -lr


def _radam(st, p, g, k, lr, wd, eps):
    """``optax.radam``: rectified where ρ_t ≥ 5, else the bias-corrected
    first moment alone."""
    g = _decayed(g, p, wd)
    m, v = _moments(st, g)
    f32 = np.float32
    ro_inf = 2.0 / (1.0 - B2) - 1.0
    b2t = _pow32(B2, k)
    ro = f32(ro_inf) - f32(f32(2 * k) * b2t) / (f32(1.0) - b2t)
    mu_hat = m / _bias(B1, k)
    if ro >= f32(5.0):
        r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                    / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        mu_hat = float(r) * mu_hat / ((v / _bias(B2, k)).sqrt() + eps)
    return mu_hat * -lr


def _lamb(st, p, g, k, lr, wd, eps):
    """``optax.lamb``: Adam's direction, the masked decoupled decay, then
    the per-parameter trust ratio ‖p‖ / ‖u‖ (1 where either norm is 0)."""
    u = _decayed(_adam_scale(st, g, k, eps), p, wd)
    pn = torch.linalg.vector_norm(p)
    un = torch.linalg.vector_norm(u)
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
    return u * ratio * -lr


def _novograd(st, p, g, k, lr, wd, eps):
    """``optax.novograd`` (b1 0.9, b2 0.25): a second moment per
    parameter, the norm of its gradient."""
    n2 = torch.linalg.vector_norm(g) ** 2
    if k == 1:
        nu = n2
        mu = g / (nu.sqrt() + eps) + wd * p
        st["exp_avg"].copy_(mu)
    else:
        nu = 0.75 * n2 + 0.25 * st["nu"].to(p.device)
        mu = st["exp_avg"].mul_(0.9).add_(g / (nu.sqrt() + eps) + wd * p)
    st["nu"] = nu.detach().clone()
    return mu * -lr


def _diffgrad(st, p, g, k, lr, wd, eps):
    """The JAX package's DiffGrad: Adam damped by ξ = σ(|g_prev − g|)."""
    g = _decayed(g, p, wd)
    m, v = _moments(st, g)
    xi = torch.sigmoid((st["prev_grad"] - g).abs())
    st["prev_grad"].copy_(g)
    mu_hat_scale = float(np.float32(1.0) / np.float32(_bias(B1, k)))
    nu_hat_scale = float(np.float32(1.0) / np.float32(_bias(B2, k)))
    return -lr * xi * (m * mu_hat_scale) / ((v * nu_hat_scale).sqrt() + eps)


def _madgrad(st, p, g, k, lr, wd, eps):
    """The JAX package's MADGRAD (momentum 0.9): λ = lr·√k weights both
    sums, the iterate is 0.9·p + 0.1·(x0 − s / (∛v + eps))."""
    lamb = float(np.float32(lr) * np.sqrt(np.float32(k)))
    g = _decayed(g, p, wd)
    s = st["grad_sum"].add_(g, alpha=lamb)
    v = st["grad_sum_sq"].add_(g * g, alpha=lamb)
    ck = 1.0 - 0.9
    p_new = (1.0 - ck) * p + ck * (st["x0"] - s / (v.pow(1.0 / 3.0) + eps))
    return p_new - p


UPDATES = {"sgd": _sgd, "adam": _adam, "adamw": _adamw, "rms": _rms,
           "radam": _radam, "ranger": _radam, "lamb": _lamb,
           "novograd": _novograd, "diffgrad": _diffgrad, "madgrad": _madgrad}
# the state tensors each update keeps beside ``step``, zeros at the start
# (``x0`` and the lookahead's ``slow`` start as copies of the parameter)
BUFFERS = {"sgd": ("momentum_buffer",), "rms": ("square_avg",),
           "adam": ("exp_avg", "exp_avg_sq"),
           "adamw": ("exp_avg", "exp_avg_sq"),
           "radam": ("exp_avg", "exp_avg_sq"),
           "ranger": ("exp_avg", "exp_avg_sq"),
           "lamb": ("exp_avg", "exp_avg_sq"), "novograd": ("exp_avg",),
           "diffgrad": ("exp_avg", "exp_avg_sq", "prev_grad"),
           "madgrad": ("grad_sum", "grad_sum_sq")}


# optax's state fields (the NamedTuple field names a JAX checkpoint keeps)
# → the port's per-parameter state keys, by base name
OPTAX_FIELDS = {
    "sgd": {"trace": "momentum_buffer"},
    "rms": {"nu": "square_avg"},
    "novograd": {"mu": "exp_avg", "nu": "nu"},
    "madgrad": {"grad_sum": "grad_sum", "grad_sum_sq": "grad_sum_sq",
                "x0": "x0"},
    "diffgrad": {"mu": "exp_avg", "nu": "exp_avg_sq",
                 "prev_grad": "prev_grad"},
}
for _name in ("adam", "adamw", "radam", "ranger", "lamb"):
    OPTAX_FIELDS[_name] = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def state_fields(optimizer: torch.optim.Optimizer) -> Tuple[Dict[str, str],
                                                            bool]:
    """(optax field → state key, whether each parameter's state has a
    ``step`` counter) of an optimizer of this registry; the lookahead's
    ``slow`` weights included where it has them."""
    if isinstance(optimizer, OptaxOptimizer):
        fields = dict(OPTAX_FIELDS[optimizer.name])
        if optimizer.inner_lookahead or optimizer.outer_lookahead:
            fields["slow"] = "slow"
        return fields, True
    if isinstance(optimizer, torch.optim.SGD):
        return dict(OPTAX_FIELDS["sgd"]), False
    return dict(OPTAX_FIELDS["adam"]), True       # torch's Adam / AdamW


class OptaxOptimizer(torch.optim.Optimizer):
    """One optax optimizer of the JAX registry, with ``_with_lr_scales``
    and the lookahead wrapper in the JAX order: ``ranger`` is
    ``lookahead(radam)`` inside the lr scales (the ×``lr_mult`` group's sync
    jump is scaled too); a ``_lookahead`` name wraps the scaled optimizer,
    so its sync moves the parameter all the way to the new slow weights. A
    parameter without a gradient takes a zero one, as every leaf of an
    optax tree has a gradient."""

    def __init__(self, groups, name: str, lookahead: bool = False,
                 eps: float = 1e-5):
        self.name = name
        self.update_fn = UPDATES[name]
        self.inner_lookahead = name == "ranger"
        self.outer_lookahead = lookahead
        super().__init__(groups, {"lr": 1e-3, "base_lr": 1e-3,
                                  "lr_mult": 1.0, "weight_decay": 0.0,
                                  "eps": eps})

    def _init_state(self, p) -> Dict[str, torch.Tensor]:
        st: Dict[str, torch.Tensor] = {"step": torch.tensor(0.0)}
        for key in BUFFERS[self.name]:
            st[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if self.name == "madgrad":
            st["x0"] = p.detach().clone()
        if self.name == "novograd":
            st["nu"] = torch.zeros((), dtype=p.dtype, device=p.device)
        if self.inner_lookahead or self.outer_lookahead:
            st["slow"] = p.detach().clone()
        return st

    @staticmethod
    def _lookahead(st, p, u, k):
        """Every ``SYNC_PERIOD``-th step the slow weights move ``SLOW_STEP``
        of the way to the fast ones (p + u), and the update becomes the
        move from p to the new slow weights."""
        if k % SYNC_PERIOD:
            return u
        slow = st["slow"]
        slow.add_(p + u - slow, alpha=SLOW_STEP)
        return slow - p

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, mult, eps = group["base_lr"], group["lr_mult"], group["eps"]
            wd = (group.get("weight_decay_unmasked", group["weight_decay"])
                  if self.name in UNMASKED else group["weight_decay"])
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p))
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st["step"] += 1
                k = int(st["step"].item())
                u = self.update_fn(st, p, g, k, lr, wd, eps)
                if self.inner_lookahead:
                    u = self._lookahead(st, p, u, k)
                if mult != 1.0:
                    u = u * mult
                if self.outer_lookahead:
                    u = self._lookahead(st, p, u, k)
                p.add_(u)
        return loss
