"""Data-parallel training on two gloo ranks against world size 1 and JAX.

One 2-rank group (``parallel.mesh.spawn``, CPU) runs every case of the
file; the parent computes the world-size-1 references and, in a thread
meanwhile, the JAX package's ``Trainer`` with ``mesh_shape={"data": 2}``
on its 8-device CPU mesh. The ranks import this file but not JAX.

* ``Trainer.train_step`` and ``eval_step`` of the flagship in fp64 with the
  ``advanced`` policy, DropBlock and the classification head's dropout on,
  deep supervision and a Lovász term (the whole batch's sort): at world
  size 2 the loss, every gradient, every BatchNorm statistic, every updated
  parameter and the eval counts equal world size 1's within 1e-12 of each
  leaf's max.
* ``GanTrainer.train_step`` and ``evaluate_ap`` likewise (fp64).
* the fp32 step at world size 2 against JAX's data-parallel step, at the
  tolerances and with the fp64 referee of tests/test_torch_train_step.py
  (its small flagship, augmentation ``none``, DropBlock's draw zeroed on
  both sides).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch import models as zoo
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    DropBlock2d)
from eyediseasesegmentation_tpu_torch.parallel import mesh as P
from eyediseasesegmentation_tpu_torch.train.gan import GanTrainer
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

WORLD, SIZE, BATCH = 2, 64, 2
LEAF_TOL = 1e-12
FLAGSHIP = {"encoder_name": "BoTSER50_Axial_Imagenet_3",
            "decoder_attention_type": "scse", "base_dim": SIZE // 32,
            "classes": 1}
DP_CONFIG = {
    "dataset_name": "IDRiD", "augmentation": "advanced", "scale_size": SIZE,
    "batch_size": BATCH, "is_fp16": False, "learning_rate": 1e-3,
    "model_name": "unetplusplusstar",
    "model_params": {**FLAGSHIP, "deep_supervision": True, "clf_head": True},
    "ds_weight": 0.5, "criterion": {"bce": 0.5, "log_dice": 0.2,
                                    "lovasz": 0.3},
    "pos_weights": [5.0], "optimizer": "adamw"}
# tests/test_torch_train_step.py's CONFIG (copied: the ranks import no JAX,
# and that file does; the parent checks they are one)
JAX_CASE_CONFIG = {
    "dataset_name": "IDRiD", "augmentation": "none", "scale_size": SIZE,
    "batch_size": BATCH, "is_fp16": False, "learning_rate": 1e-3,
    "model_name": "unetplusplusstar", "model_params": FLAGSHIP,
    "criterion": {"bce": 0.8, "log_dice": 0.2}, "pos_weights": [5.0],
    "optimizer": "adamw", "mesh_shape": {"data": 1}}
GAN_CONFIG = {"image_size": 32, "patch_size": 8, "generator": "classic_unet",
              "generator_params": {"filters": [8, 16], "classes": 1},
              "d_weight": 0.01, "g_learning_rate": 1e-3,
              "d_learning_rate": 1e-3, "batch_size": BATCH}


def _batch(seed, hw=(SIZE, SIZE + 16)):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (BATCH, *hw, 3)).astype(np.uint8)
    masks = (rng.rand(BATCH, *hw) < 0.1).astype(np.uint8)
    return images, masks


def _fp64(*modules):
    for m in modules:
        m.double()
        for mod in m.modules():
            if getattr(mod, "dtype", None) == torch.float32:
                mod.dtype = torch.float64


def _snapshot(model):
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.rsplit(".", 1)[-1].startswith("running")}}


def dp_step(mesh_shape):
    """The fp64 flagship train step and an eval step of a padded batch
    (n_valid 1); the mesh is the job's (world size 1 in the parent)."""
    trainer = Trainer(dict(DP_CONFIG, mesh_shape=mesh_shape), device="cpu")
    zoo.init_random(trainer.model, torch.Generator().manual_seed(31))
    _fp64(trainer.model)
    images, masks = _batch(11)
    m = trainer.train_step(images, masks, torch.Generator().manual_seed(7),
                           1e-3)
    out = {"metrics": {k: v.item() for k, v in m.items()},
           **_snapshot(trainer.model)}
    ev = trainer.eval_step(*_batch(12), 1)
    out["eval"] = {k: ev[k].clone() for k in ("inter", "pred", "true", "tp",
                                              "ap", "pp", "loss", "probs")}
    return out


class _Dataset:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.items = [{"image": rng.randint(0, 256, (32, 32, 3)).astype(
            np.float32), "mask": (rng.rand(32, 32) < 0.2).astype(np.float32)}
            for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def gan_step(mesh_shape):
    """One fp64 GAN step, then ``evaluate_ap`` over 3 images (the second
    batch padded)."""
    g = GanTrainer(dict(GAN_CONFIG, mesh_shape=mesh_shape), device="cpu")
    zoo.init_random(g.generator, torch.Generator().manual_seed(5))
    _fp64(g.generator, g.discriminator)
    g.dtype = torch.float64
    images, masks = _batch(13, (32, 32))
    m = g.train_step(images.astype(np.float64), masks.astype(np.float64))
    return {"metrics": {k: v.item() for k, v in m.items()},
            "g": _snapshot(g.generator), "d": _snapshot(g.discriminator),
            "ap": g.evaluate_ap(_Dataset(3, 14), batch_size=BATCH)}


def _no_blocks(self, x, n=None):
    """DropBlock's draw zeroed (the keep / renormalise multiply still
    runs), as tests/test_torch_train_step.py zeroes it on both sides."""
    return torch.zeros((x.shape[0] if n is None else n, 1, *x.shape[2:]),
                       dtype=x.dtype)


def jax_case_step(mesh_shape):
    """tests/test_torch_train_step.py's fp32 step (augmentation none,
    DropBlock's draw zeroed) on the port's seed-1999 weights: (loss,
    gradients, batch_stats) in the JAX layout."""
    saved = DropBlock2d.draw
    DropBlock2d.draw = _no_blocks
    try:
        trainer = Trainer(dict(JAX_CASE_CONFIG, mesh_shape=mesh_shape),
                          seed=1999, device="cpu")
        images, masks = _batch(11, (SIZE, SIZE))
        loss = trainer.train_step(images, masks, torch.Generator(),
                                  1e-3)["loss"].item()
    finally:
        DropBlock2d.draw = saved
    grads = {n: p.grad for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return {"loss": loss, "grads": torch_to_flax(grads)["params"],
            "stats": torch_to_flax(trainer.model)["batch_stats"],
            "mesh": trainer.mesh.shape}


def _ranks(mesh, out):
    torch.set_num_threads(2)
    res = {}
    for batch_size, shape in ((3, None), (3, {"data": 2})):
        try:
            Trainer(dict(DP_CONFIG, batch_size=batch_size, mesh_shape=shape),
                    device="cpu")
        except ValueError as e:
            res[f"error_{shape is not None}"] = str(e)
    res["dp"] = dp_step({"data": WORLD})
    res["gan"] = gan_step(None)
    res["jax_case"] = jax_case_step({"data": WORLD})
    torch.save(res, f"{out}/rank{mesh.rank}.pt")


def _jax_reference(variables):
    """JAX's Trainer with mesh_shape {"data": 2}: loss, gradients and new
    batch_stats of tests/test_torch_train_step.py's step."""
    import jax
    import jax.numpy as jnp
    from eyediseasesegmentation_tpu.train import trainer as JT
    from test_torch_train_step import CONFIG, _grad_keeper, _no_blocks

    images, masks = _batch(11, (SIZE, SIZE))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _no_blocks)
        jtr = JT.Trainer(dict(CONFIG, mesh_shape={"data": WORLD}), seed=1999)
        assert dict(jtr.mesh.shape) == {"data": WORLD}
        jtr.tx = _grad_keeper()
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
        state = JT.TrainState(params, stats, jtr.tx.init(params),
                              jnp.zeros([], jnp.int32))
        new, metrics = jtr._train_step(
            state, jnp.asarray(images), jnp.asarray(masks),
            jax.random.PRNGKey(5), jnp.float32(1e-3))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (float(metrics["loss"]), to_np(new.opt_state.inner_state),
            to_np(new.batch_stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("data_parallel")
    from test_torch_train_step import CONFIG, _batch as step_batch
    from test_torch_train_step import _exact_grads
    assert CONFIG == JAX_CASE_CONFIG
    for a, b in zip(step_batch(), _batch(11, (SIZE, SIZE))):
        np.testing.assert_array_equal(a, b)      # that test's batch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(P.spawn, _ranks, WORLD, "cpu", str(out))
        # the JAX reference takes the port's seed-1999 weights
        trainer = Trainer(CONFIG, seed=1999, device="cpu")
        variables = torch_to_flax(trainer.model)
        del trainer
        jax_ref = pool.submit(_jax_reference, variables)
        ref = {"dp": dp_step(None), "gan": gan_step(None)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(DropBlock2d, "draw", _no_blocks)
            ref["exact"] = _exact_grads(variables, {})
        ranks.result()
        ref["jax"] = jax_ref.result()
    torch.set_num_threads(threads)
    ref["ranks"] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]
    return ref


def _hold_leaves(got, want, tol=LEAF_TOL):
    """Every leaf of ``want`` against ``got`` within ``tol`` of its max, or
    of the largest leaf's max where that is more: a gradient that vanishes
    by an invariance (an attention norm's bias) is rounding noise, 1e-16 of
    the others. Returns the number held."""
    assert got.keys() == want.keys()
    top = {k: w.abs().max().item() if w.numel() else 0.0
           for k, w in want.items()}
    floor = tol * max(top.values(), default=0.0)
    for k, w in want.items():
        err = (got[k] - w).abs().max().item() if w.numel() else 0.0
        assert err <= max(tol * top[k], floor), (k, err, top[k])
    return len(want)


def test_mesh_shape_data_2_builds_and_misfits_raise(runs):
    for res in runs["ranks"]:
        assert res["jax_case"]["mesh"] == {"data": WORLD}
        assert "batch_size 3 on 2 ranks" in res["error_False"]
        assert "gcd = 1" in res["error_False"]
        assert res["error_True"] == ("mesh_shape data 2 does not divide "
                                     "batch_size 3")


# AdamW's first step divides each gradient by its magnitude plus eps 1e-8:
# a near-zero gradient's 1e-16 rounding difference moves its parameter by
# up to lr / eps = 1e5 times that
PARAM_TOL = 1e-9


@pytest.mark.parametrize("part", ["grads", "params", "stats"])
def test_train_step_world_2_equals_world_1(runs, part):
    want = runs["dp"]
    tol = PARAM_TOL if part == "params" else LEAF_TOL
    for res in runs["ranks"]:
        got = res["dp"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= LEAF_TOL * max(abs(v), 1e-30)
        assert _hold_leaves(got[part], want[part], tol) > 100


def test_eval_step_world_2_equals_world_1(runs):
    want = runs["dp"]["eval"]
    for res in runs["ranks"]:
        got = res["dp"]["eval"]
        for k in ("inter", "pred", "true", "tp", "ap", "pp"):
            assert torch.equal(got[k], want[k]), k
        _hold_leaves({"loss": got["loss"]}, {"loss": want["loss"]})
        # the probabilities are the eval step's fp32 sigmoid: one ulp
        torch.testing.assert_close(got["probs"], want["probs"], rtol=0,
                                   atol=2 ** -23)


@pytest.mark.parametrize("model", ["g", "d"])
def test_gan_step_world_2_equals_world_1(runs, model):
    want = runs["gan"]
    for res in runs["ranks"]:
        got = res["gan"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= LEAF_TOL * abs(v), k
        for part in ("grads", "params", "stats"):
            _hold_leaves(got[model][part], want[model][part],
                         PARAM_TOL if part == "params" else LEAF_TOL)
        # per-image APs add in fp32, the ranks' sums then over the ranks:
        # another order than world size 1's
        assert abs(got["ap"] - want["ap"]) <= 2 ** -23 * want["ap"] * 3


def test_train_step_world_2_matches_jax_data_2(runs):
    from test_torch_train_step import (EXACT_MEDIAN, GRAD_FLOOR, GRAD_LEAF,
                                       LOSS_RTOL, STATS_FLOOR, STATS_LEAF,
                                       STATS_MEDIAN, _hold, _leaves,
                                       _median_distance)
    want_loss, want_grads, want_stats = runs["jax"]
    for res in runs["ranks"]:
        got = res["jax_case"]
        assert abs(got["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss)
        assert _hold(got["grads"], want_grads, GRAD_LEAF, GRAD_FLOOR,
                     "grad") == len(list(_leaves(want_grads)))
        assert _median_distance(got["grads"], runs["exact"]) <= EXACT_MEDIAN
        _hold(got["stats"], want_stats, STATS_LEAF, STATS_FLOOR,
              "batch_stats", STATS_MEDIAN)
    assert _median_distance(want_grads, runs["exact"]) <= EXACT_MEDIAN
