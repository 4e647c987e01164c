"""Port parity: optimizers, parameter groups and schedulers.

The optimizers run on a slice of the small flagship's parameters that spans
its three lr groups (encoder stem and layers 1-3 at lr × 0.1; ``pos_enc``
tables without weight decay; the rest), with the JAX package's lr scales
and weight-decay mask on their flax paths, fed the same numpy-seeded
gradients as the JAX package's optax chains, with a weight decay large
enough to show: torch's three classes for three steps, the other seven
names and two lookahead wrappers for eight steps with the learning rate
changed after the third (past a lookahead sync at step 5 and RAdam's
rectification from step 6), the parameters within 1e-6 of each leaf's
largest. A ``ranger`` run resumed from a checkpoint written at step 3
equals the run that never stopped. The groups partition the parameters as
the JAX scale function partitions their flax paths.
Every scheduler of the registry gives the JAX one's learning rates
exactly.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import optax

from eyediseasesegmentation_tpu.optim import optimizers as JO
from eyediseasesegmentation_tpu.optim import schedulers as JS
from eyediseasesegmentation_tpu.train import param_groups as JP
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import (flax_to_torch,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.optim import optimizers as TO
from eyediseasesegmentation_tpu_torch.optim import schedulers as TS
from eyediseasesegmentation_tpu_torch.train import param_groups as TP

MODEL = "unetplusplusstar"
PARAMS = {"base_dim": 2, "decoder_attention_type": "scse", "classes": 1}
LR, WD = 1e-2, 0.05


@pytest.fixture(scope="module")
def flagship():
    model = tzoo.get_model(MODEL, PARAMS, training=True, device="cpu")
    tzoo.init_random(model, torch.Generator().manual_seed(3))
    return model


# modules of the flagship whose parameters span the three groups
SLICE = ("encoder.seresnet.stem_conv", "encoder.seresnet.stem_bn",
         "encoder.seresnet.layer1_block0", "encoder.layer4_shared.height_att",
         "decoder.x_0_0.h_catt", "decoder.x_0_4", "segmentation_head")


def _slice(model, paths=SLICE):
    """A module holding ``paths`` under the same dotted names."""
    root = torch.nn.Module()
    for path in paths:
        node, src = root, model
        *parents, leaf = path.split(".")
        for name in parents:
            src = getattr(src, name)
            if not hasattr(node, name):
                node.add_module(name, torch.nn.Module())
            node = getattr(node, name)
        node.add_module(leaf, getattr(src, leaf))
    return root


def _flax_paths(model):
    """{torch parameter name: JAX keystr of its flax path}."""
    names = [n for n, _ in model.named_parameters()]
    tagged = {k: torch.full_like(v, float(names.index(k)))
              if k in names else v for k, v in model.state_dict().items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        torch_to_flax(tagged)["params"])
    return {names[int(np.asarray(leaf).flat[0])]: jax.tree_util.keystr(path)
            for path, leaf in flat}


def test_param_groups_partition_as_jax(flagship):
    scale = JP.lr_scale_fn_for(MODEL)
    paths = _flax_paths(flagship)
    groups = TP.param_groups(flagship, MODEL, WD)
    seen = []
    for g in groups:
        for name in g["names"]:
            lr_mult, wd_mult = scale(paths[name])
            assert g["lr_mult"] == lr_mult, name
            assert g["weight_decay"] == (WD if wd_mult > 0 else 0.0), name
            seen.append(name)
    assert sorted(seen) == sorted(n for n, _ in flagship.named_parameters())
    assert sorted((g["lr_mult"], g["weight_decay"]) for g in groups) == [
        (0.1, WD), (1.0, 0.0), (1.0, WD)]


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(name, flagship):
    full = tzoo.get_model(MODEL, PARAMS, training=True, device="cpu")
    full.load_state_dict(flagship.state_dict())
    model = _slice(full)
    params = torch_to_flax(model)["params"]
    tx = JO.get_optimizer(name, LR, weight_decay=WD,
                          lr_scale_fn=JP.lr_scale_fn_for(MODEL),
                          wd_mask=JP.wd_mask_for(MODEL))
    state = tx.init(params)

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    opt = TO.get_optimizer(name, TP.param_groups(model, MODEL, WD), LR)
    rng = np.random.RandomState(8)
    tparams = dict(model.named_parameters())
    assert len({(g["lr_mult"], g["weight_decay"])
                for g in opt.param_groups}) == 3
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), params)
        params, state = jax.block_until_ready(step(grads, state, params))
        for k, g in flax_to_torch({"params": grads}).items():
            # a copy: torch's in-place updates must not reach the numpy
            # gradients JAX was handed
            tparams[k].grad = g.clone()
        opt.step()
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                           params)})
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_set_learning_rate_scales_each_group(flagship):
    opt = TO.get_optimizer("adamw", TP.param_groups(flagship, MODEL, WD), LR)
    TO.set_learning_rate(opt, 3e-4)
    assert sorted(g["lr"] for g in opt.param_groups) == pytest.approx(
        [3e-5, 3e-4, 3e-4])
    assert all(g["eps"] == 1e-5 for g in opt.param_groups)
    # every name of the JAX registry builds, with and without lookahead,
    # and takes the base rate in every group
    for name in TO.NAMES:
        for full in (name, name + "_lookahead"):
            opt = TO.get_optimizer(full, TP.param_groups(flagship, MODEL, WD),
                                   LR)
            TO.set_learning_rate(opt, 3e-4)
            assert sorted(g["lr"] for g in opt.param_groups) == \
                pytest.approx([3e-5, 3e-4, 3e-4])
            assert all(g["base_lr"] == 3e-4 for g in opt.param_groups)
    with pytest.raises(KeyError):
        TO.get_optimizer("adagrad", TP.param_groups(flagship, MODEL, WD), LR)


# the three groups again, without layer 4's attention (the cases' time)
REST_SLICE = ("encoder.seresnet.stem_conv", "encoder.seresnet.stem_bn",
              "encoder.seresnet.layer1_block0", "decoder.x_0_0.h_catt",
              "decoder.x_0_4", "segmentation_head")
REST = ["rms", "radam", "ranger", "lamb", "diffgrad", "novograd", "madgrad",
        "adam_lookahead", "radam_lookahead"]
REST_STEPS, LR_CHANGE_AT, LR2 = 8, 3, 4e-3


@pytest.fixture(scope="module")
def rest_case(flagship):
    """The slice's flax parameters and the seeded gradients, each step's
    in the JAX tree and as torch tensors."""
    params = torch_to_flax(_slice(flagship, REST_SLICE))["params"]
    rng = np.random.RandomState(11)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), params)
        for _ in range(REST_STEPS)]
    return params, grads, [flax_to_torch({"params": g}) for g in grads]


def _rest_model(flagship, name):
    model = _slice(copy.deepcopy(flagship), REST_SLICE)
    opt = TO.get_optimizer(name, TP.param_groups(model, MODEL, WD), LR)
    return model, opt, dict(model.named_parameters())


def _torch_steps(opt, tparams, grads, start, stop):
    for i in range(start, stop):
        if i == LR_CHANGE_AT:
            TO.set_learning_rate(opt, LR2)
        for k, g in grads[i].items():
            tparams[k].grad = g.clone()
        opt.step()


@pytest.mark.parametrize("name", REST)
def test_optimizer_rest_matches_optax(name, flagship, rest_case):
    params, grads, tgrads = rest_case
    tx = JO.get_optimizer(name, LR, weight_decay=WD,
                          lr_scale_fn=JP.lr_scale_fn_for(MODEL),
                          wd_mask=JP.wd_mask_for(MODEL))
    state = tx.init(params)

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for i in range(REST_STEPS):
        if i == LR_CHANGE_AT:
            state.hyperparams["learning_rate"] = np.float32(LR2)
        params, state = step(grads[i], state, params)
    _, opt, tparams = _rest_model(flagship, name)
    _torch_steps(opt, tparams, tgrads, 0, REST_STEPS)
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                           params)})
    for k, p in tparams.items():
        tol = 1e-6 * max(float(want[k].abs().max()), 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=tol, err_msg=k)


def test_ranger_resume_is_exact(flagship, rest_case, tmp_path):
    from eyediseasesegmentation_tpu_torch.train.checkpoint import (
        resume_state, restore_into, save_checkpoint)

    grads = rest_case[2]
    _, opt, tparams = _rest_model(flagship, "ranger")
    _torch_steps(opt, tparams, grads, 0, REST_STEPS)
    stopped, opt2, tparams2 = _rest_model(flagship, "ranger")
    _torch_steps(opt2, tparams2, grads, 0, 3)
    save_checkpoint(tmp_path / "best_full.ckpt",
                    resume_state(stopped, opt2, 3, 0))
    resumed, opt3, tparams3 = _rest_model(flagship, "ranger")
    assert restore_into(resumed, opt3, tmp_path / "best_full.ckpt") == {
        "step": 3, "epoch": 0}
    TO.set_learning_rate(opt3, LR)
    _torch_steps(opt3, tparams3, grads, 3, REST_STEPS)
    for k, p in tparams.items():
        assert torch.equal(p, tparams3[k]), k


@pytest.mark.parametrize("name", ["reduce", "poly", "cos", "cos2", "cosr",
                                  "cosrd", "1cycle", "exp", "clr",
                                  "multistep", "simple", "none"])
def test_scheduler_matches_jax(name):
    want = JS.get_scheduler(name, 1e-3, 30, 7, mode="max")
    got = TS.get_scheduler(name, 1e-3, 30, 7, mode="max")
    if want is None:
        assert got is None
        return
    assert got.batch_update == want.batch_update
    metrics = np.random.RandomState(4).rand(30)
    metrics[10:] = 0.1          # a plateau for ReduceLROnPlateau
    for i in range(30):
        if want.batch_update:
            assert got.batch_lr(i) == want.batch_lr(i)
        else:
            assert got.epoch_lr(i, float(metrics[i])) == \
                want.epoch_lr(i, float(metrics[i]))
