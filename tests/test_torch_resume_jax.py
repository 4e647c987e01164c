"""Port parity: resuming from the JAX package's ``best_full.ckpt``.

``classic_unet`` at filters 8-16 (32², batch 2, fp32, no augmentation),
weights drawn in the port: the JAX trainer takes two steps and writes
``{"state": TrainState, "epoch"}`` as its ``fit`` does. The port's
``restore_into`` (what ``Trainer.fit(resume_path=...)`` calls) reads it:
the weights and batch statistics through ``convert``, each optax state
tree onto the port's per-parameter state. One more step on each side from
the same batch: the loss within 1e-6 relative and every parameter and
running statistic within ``LEAF_TOL`` of the leaf's largest, for
``adamw``, ``sgd`` (torch's classes) and ``ranger``,
``radam_lookahead``, ``madgrad`` and ``novograd`` (``OptaxOptimizer``;
the third step is not a lookahead sync, so the slow weights are held
directly). A tree that does not fit the model raises and names the first
missing key.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.optim import optimizers as JO
from eyediseasesegmentation_tpu.train import checkpoint as JC
from eyediseasesegmentation_tpu.train import trainer as JT
from eyediseasesegmentation_tpu.train.param_groups import (lr_scale_fn_for,
                                                           wd_mask_for)
from eyediseasesegmentation_tpu_torch.convert import (flax_to_torch,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.models import get_model, init_random
from eyediseasesegmentation_tpu_torch.train.checkpoint import restore_into
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

LEAF_TOL = 1e-5
CFG = {"model_name": "classic_unet",
       "model_params": {"filters": [8, 16], "classes": 1},
       "scale_size": 32, "batch_size": 2, "is_fp16": False,
       "augmentation": "none", "criterion": {"bce": 0.8, "log_dice": 0.2},
       "weight_decay": 1e-4, "mesh_shape": {"data": 1}}
LR = 1e-3


def _batch(seed):
    rng = np.random.RandomState(seed)
    imgs = np.round(rng.rand(2, 32, 32, 3) * 255).astype(np.float32)
    masks = (rng.rand(2, 32, 32) < 0.3).astype(np.float32)
    return imgs, masks


def _jax_step(tr, state, seed):
    imgs, masks = _batch(seed)
    return tr._train_step(state, jnp.asarray(tr._wire(imgs)),
                          jnp.asarray(tr._wire(masks)),
                          jax.random.PRNGKey(seed), jnp.asarray(LR,
                                                                jnp.float32))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per optimizer: the checkpoint after two JAX steps and the JAX state
    and metrics after the third."""
    # the initial weights drawn in the port and handed over in flax's tree
    model = get_model("classic_unet", CFG["model_params"], device="cpu")
    start = torch_to_flax(init_random(model, torch.Generator().manual_seed(0)))
    out = {}
    for opt in ("adamw", "sgd", "ranger", "radam_lookahead", "madgrad",
                "novograd"):
        tr = JT.Trainer({**CFG, "optimizer": opt})
        # init_state's optimizer half (its model.init, compiled, is the
        # costly half, and the weights come from the port)
        tr.tx = JO.get_optimizer(opt, learning_rate=LR,
                                 weight_decay=CFG["weight_decay"],
                                 lr_scale_fn=lr_scale_fn_for("classic_unet"),
                                 wd_mask=wd_mask_for("classic_unet"))
        params, stats = jax.tree_util.tree_map(
            jnp.array, (start["params"], start["batch_stats"]))
        state = jax.device_put(   # placed as init_state places it
            JT.TrainState(params, stats, tr.tx.init(params),
                          jnp.zeros([], jnp.int32)),
            JT.replicated_sharding(tr.mesh))
        for seed in (1, 2):
            state, _ = _jax_step(tr, state, seed)
        path = tmp_path_factory.mktemp(opt) / "best_full.ckpt"
        JC.save_checkpoint(path, {"state": state, "epoch": 4})
        state, metrics = _jax_step(tr, state, 3)
        out[opt] = (path, jax.tree_util.tree_map(np.asarray, state),
                    float(metrics["loss"]))
    return out


@pytest.mark.parametrize("opt", ["adamw", "sgd", "ranger", "radam_lookahead",
                                 "madgrad", "novograd"])
def test_resume_from_jax_matches_the_next_jax_step(opt, jax_runs):
    path, want, want_loss = jax_runs[opt]
    port = Trainer({**CFG, "optimizer": opt}, device="cpu")
    assert restore_into(port.model, port.optimizer, path) == {
        "step": 2, "epoch": 4}
    for st in port.optimizer.state.values():
        if "step" in st:
            assert st["step"].ndim == 0 and st["step"].device.type == "cpu"
            assert float(st["step"]) == 2.0
    port.step = 2
    metrics = port.train_step(*_batch(3), torch.Generator().manual_seed(0),
                              LR)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-6)
    ref = flax_to_torch({"params": want.params,
                         "batch_stats": want.batch_stats})
    got = port.model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        top = max(float(v.abs().max()), 1e-30)
        assert float((got[k] - v).abs().max()) <= LEAF_TOL * top, k


def test_resume_refuses_a_tree_that_does_not_fit(jax_runs, tmp_path):
    path = jax_runs["adamw"][0]
    other = Trainer({**CFG, "model_params": {"filters": [8, 16, 32],
                                             "classes": 1}}, device="cpu")
    with pytest.raises(ValueError, match="not set"):
        restore_into(other.model, other.optimizer, path)
    tree = JC.load_checkpoint(path)
    del tree["state"]["opt_state"]["inner_state"]["0"]["nu"]
    JC.save_checkpoint(tmp_path / "cut.ckpt", tree)
    port = Trainer({**CFG, "optimizer": "adamw"}, device="cpu")
    with pytest.raises(KeyError, match="'nu'"):
        restore_into(port.model, port.optimizer, tmp_path / "cut.ckpt")
