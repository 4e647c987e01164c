"""Port parity: one train step of the flagship against the JAX Trainer.

The JAX side is the JAX package's own ``Trainer._train_step`` (jitted,
fp32, augmentation ``none``), with one change made here and not in the
package: its optimizer is a transformation that returns zero updates and
keeps the gradients as its state, so the step hands back the gradients, the
loss and the new ``batch_stats``. DropBlock is made the identity on both
sides: the JAX Bernoulli draw is replaced with zeros (so its keep /
renormalise multiply still runs) and the port's draw likewise. The JAX step
is compiled once per case (plain and deep supervision); the finetune case
holds the port to the plain case's JAX gradients and to the JAX finetune
rule (encoder statistics restored, encoder weights fixed).

Tolerances. The loss at 1e-5 relative. The gradients and statistics of
each module are held to JAX at 1e-5 in test_torch_train_modules.py; here
the whole network is, where fp32 rounding compounds through some hundred
train-mode BatchNorms. Measured against the port run in fp64 (the exact
gradient, to fp32 eyes), JAX's fp32 gradients lie a median 2.1e-3 (plain)
and 9.4e-3 (deep supervision) of a leaf's max away, the port's fp32 ones
4.9e-3 and 2.0e-2, so no fixed 1e-4 of a leaf's max can hold for either
package. The test holds instead:

* each gradient leaf to JAX at ``GRAD_LEAF`` of its max or ``GRAD_FLOOR``
  of the largest gradient, whichever is larger (leaves whose exact
  gradient vanishes by an invariance, such as an attention norm's bias,
  are rounding noise on the scale of the others);
* against the fp64 port: JAX's fp32 gradients within a median
  ``EXACT_MEDIAN`` of it (the port computes the function JAX computes),
  and the port's fp32 ones too (the port's rounding is of the same
  order);
* ``batch_stats`` per leaf to JAX at ``STATS_LEAF`` of its max or
  ``STATS_FLOOR`` of the largest, their median at ``STATS_MEDIAN``.

An error of wiring (a missing loss term, a wrong pyramid, a module on the
wrong path, a frozen scope that moves) changes leaves by far more.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eyediseasesegmentation_tpu.train import trainer as JT
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.convert import load_flax
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    DropBlock2d)
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

from test_torch_axial import random_flax_variables

SIZE, BATCH = 64, 2
CONFIG = {
    "dataset_name": "IDRiD", "augmentation": "none", "scale_size": SIZE,
    "batch_size": BATCH, "is_fp16": False, "learning_rate": 1e-3,
    "model_name": "unetplusplusstar",
    "model_params": {"encoder_name": "BoTSER50_Axial_Imagenet_3",
                     "decoder_attention_type": "scse", "base_dim": SIZE // 32,
                     "classes": 1},
    "criterion": {"bce": 0.8, "log_dice": 0.2}, "pos_weights": [5.0],
    "optimizer": "adamw", "mesh_shape": {"data": 1}}
CASES = {"plain": {},
         "deep_supervision": {"model_params": {**CONFIG["model_params"],
                                               "deep_supervision": True},
                              "ds_weight": 0.5}}
LOSS_RTOL = 1e-5
GRAD_LEAF, GRAD_FLOOR = 1e-1, 1e-3
EXACT_MEDIAN = 5e-2
STATS_LEAF, STATS_FLOOR, STATS_MEDIAN = 1e-3, 1e-5, 1e-5


def _batch():
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8)
    masks = (rng.rand(BATCH, SIZE, SIZE) < 0.1).astype(np.uint8)
    return images, masks


def _grad_keeper():
    """An optax transformation with zero updates whose state is the last
    gradients, under ``inject_hyperparams`` as the Trainer's own."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.inject_hyperparams(
        lambda learning_rate: optax.GradientTransformation(init, update))(
            learning_rate=1e-3)


def _no_blocks(key, p, shape=None, *a, **k):
    return jnp.zeros(shape, bool)


@pytest.fixture(scope="module")
def jax_steps():
    """{case: (variables, loss, grads, new batch_stats)} of the JAX step."""
    images, masks = _batch()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _no_blocks)
        for case, extra in CASES.items():
            cfg = {**CONFIG, **extra}
            jtr = JT.Trainer(cfg, seed=1999)
            shapes = jax.eval_shape(
                partial(jtr.model.init, train=False),
                {"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
            variables = random_flax_variables(shapes, seed=31)
            jtr.tx = _grad_keeper()
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
            stats = jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"])
            state = JT.TrainState(params, stats, jtr.tx.init(params),
                                  jnp.zeros([], jnp.int32))
            new, metrics = jtr._train_step(
                state, jnp.asarray(images), jnp.asarray(masks),
                jax.random.PRNGKey(5), jnp.float32(1e-3))
            to_np = partial(jax.tree_util.tree_map, np.asarray)
            out[case] = (variables, float(metrics["loss"]),
                         to_np(new.opt_state.inner_state),
                         to_np(new.batch_stats))
    return out


def _port_step(variables, extra, monkeypatch):
    monkeypatch.setattr(DropBlock2d, "draw",
                        lambda self, x: torch.zeros_like(x[:, :1]))
    trainer = Trainer({**CONFIG, **extra}, seed=1999, device="cpu")
    load_flax(trainer.model, variables)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    images, masks = _batch()
    metrics = trainer.train_step(images, masks, torch.Generator(), 1e-3)
    grads = {n: p.grad for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return (trainer, before, float(metrics["loss"]),
            torch_to_flax(grads)["params"],
            torch_to_flax(trainer.model)["batch_stats"])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _hold(got, want, leaf_tol, floor, what, median_tol=None,
          skip=lambda path: False):
    """Every leaf of ``want`` against ``got``: |Δ| ≤ max(leaf_tol ·
    max|leaf|, floor · max over all leaves); with ``median_tol`` also the
    median over leaves of |Δ| / max|leaf|. Returns the leaves held."""
    leaves = [(p, w) for p, w in _leaves(want) if not skip(p)]
    scale = max(np.abs(w).max() for _, w in leaves)
    rel = []
    for path, w in leaves:
        err = np.abs(np.asarray(_get(got, path)) - w).max()
        top = np.abs(w).max()
        bound = max(leaf_tol * top, floor * scale)
        assert err <= bound, (what, "/".join(path), err, top, scale)
        rel.append(err / top if top > 0 else 0.0)
    if median_tol is not None:
        assert np.median(rel) <= median_tol, (what, np.median(rel))
    return len(leaves)


def _exact_grads(variables, extra):
    """The port's gradients of the same step in fp64 (weights, inputs,
    statistics, softmax and loss)."""
    trainer = Trainer({**CONFIG, **extra}, seed=1999, device="cpu")
    model = load_flax(trainer.model, variables).double()
    for mod in model.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    model.train()
    images, masks = _batch()
    x = trainer.transform.test(torch.from_numpy(images).double())
    out = model(x.permute(0, 3, 1, 2))
    trainer.compute_loss(out, torch.from_numpy(masks).double()[:, None])[
        0].backward()
    return torch_to_flax({n: p.grad for n, p in model.named_parameters()})[
        "params"]


def _median_distance(grads, exact):
    rel = []
    for path, e in _leaves(exact):
        top = np.abs(e).max()
        if top > 1e-12:   # leaves whose exact gradient vanishes: no scale
            rel.append(np.abs(np.asarray(_get(grads, path)) - e).max() / top)
    return float(np.median(rel))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, jax_steps, monkeypatch):
    variables, want_loss, want_grads, want_stats = jax_steps[case]
    _, _, loss, grads, stats = _port_step(variables, CASES[case],
                                          monkeypatch)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert _hold(grads, want_grads, GRAD_LEAF, GRAD_FLOOR,
                 "grad") == len(list(_leaves(want_grads)))
    exact = _exact_grads(variables, CASES[case])
    assert _median_distance(want_grads, exact) <= EXACT_MEDIAN
    assert _median_distance(grads, exact) <= EXACT_MEDIAN
    _hold(stats, want_stats, STATS_LEAF, STATS_FLOOR, "batch_stats",
          STATS_MEDIAN)


# (path, elements per channel n, the rule): conv BatchNorms move their
# running variance by the biased batch variance, the axial norms by the
# unbiased one; at these small n the two rules differ by 0.1 · var / (n − 1)
PINS = [(("encoder", "layer4_shared", "in_bn", "var"), 8, "biased"),
        (("decoder", "x_0_0", "init_bn", "var"), 8, "biased"),
        (("encoder", "layer4_shared", "height_att", "to_qkv_bn_var"), 8,
         "unbiased"),
        (("decoder", "x_0_0", "h_catt", "attention_norm_var"), 16,
         "unbiased")]
PIN_TOL = 1e-4


def test_train_step_pins_both_running_variances(jax_steps, monkeypatch):
    """Each running variance against JAX at ``PIN_TOL`` of its max, where
    the other rule (biased for unbiased, or the reverse) would be off by
    more than ten times that; a frozen encoder BN did not move."""
    variables, _, _, want = jax_steps["plain"]
    _, _, _, _, got = _port_step(variables, {}, monkeypatch)
    for path, n, rule in PINS:
        w, g = _get(want, path), _get(got, path)
        old = _get(variables["batch_stats"], path)
        batch_var = (w - 0.9 * old) / 0.1
        f = n / (n - 1) if rule == "biased" else (n - 1) / n
        other = 0.9 * old + 0.1 * batch_var * f
        bound = PIN_TOL * np.abs(w).max()
        assert np.abs(g - w).max() <= bound, path
        assert np.abs(other - w).max() > 10 * bound, path
    frozen = ("encoder", "seresnet", "layer3_block5", "bn3", "var")
    np.testing.assert_array_equal(_get(got, frozen),
                                  _get(variables["batch_stats"], frozen))


def test_train_step_finetune_freezes_the_encoder(jax_steps, monkeypatch):
    """``finetune``: the encoder's weights leave the optimizer and never
    move, its BN statistics are restored after the step (the JAX rule:
    ``_zero_scopes`` / ``_restore_scopes`` on the ``encoder`` scope), and
    the rest of the step is the plain one."""
    variables, want_loss, want_grads, want_stats = jax_steps["plain"]
    extra = {"finetune": True}
    trainer, before, loss, grads, stats = _port_step(variables, extra,
                                                     monkeypatch)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert "encoder" not in grads
    assert not any(n.startswith("encoder.") for g in
                   trainer.optimizer.param_groups for n in g["names"])
    encoder = lambda path: path[0] == "encoder"   # noqa: E731
    _hold(grads, want_grads, GRAD_LEAF, GRAD_FLOOR, "grad", skip=encoder)
    after = trainer.model.state_dict()
    for k, v in before.items():
        if k.startswith("encoder."):
            assert torch.equal(after[k], v), k
    _hold(stats, want_stats, STATS_LEAF, STATS_FLOOR, "batch_stats",
          STATS_MEDIAN, skip=encoder)
