"""Port parity: GAN fine-tuning (``train/gan.py``).

The port's patch grid and discriminator against the JAX package's on the
same numpy-seeded inputs (the discriminator through ``convert``, at a map
whose third conv pads (1, 2)); one whole GAN step, JAX ``GanTrainer._step``
against the port's ``train_step`` from the JAX trainer's own weights
(``classic_unet`` at filters (4, 8), 16², patches of 8; no dropout): the
four losses within 1e-5 relative and every updated G, D and
batch-statistics leaf within 1e-5 of the leaf's largest, in fp32 on both
sides, or, for a leaf where fp32 cannot hold that, within ``EXACT_TOL`` of
the leaf's largest of the port's step in fp64 (the exact step, to fp32
eyes). Adam's first step is lr·g / (|g| + 1e-5), so an element whose
gradient is near zero (a BatchNorm bias, a bias of D's first conv on raw
[0, 255] patches) takes its rounding from the gradient's: measured, the
port's fp32 leaves lie at most 5.3e-5 of a leaf's largest from the fp64
step and JAX's up to 0.33 (D's ``conv0`` bias), while a wiring fault (G
in train mode for the D step, which moves its statistics and D's inputs)
fails the test. The median over the leaves of JAX's distance to the fp64
step is held to 1e-5, so the fp64 step is the one JAX computes. The
adversarial term is d_weight·mean(1 − D(fake)) with D(fake) within 1e-3 of
1 on these raw [0, 255] images, so fp32 knows it only to half an ulp of 1
(6e-8) times d_weight, 1e-4 of its value in either package: it is held at
1e-5 relative plus ``ADV_ATOL`` = d_weight·2⁻²² (four such roundings).
A 2-epoch ``fit`` on the port's synthetic tree writes the JAX rows and a
``best_gan.ckpt`` that the JAX package reads with its own key paths and
shapes; a fresh trainer loads it and gives the trained generator's
probabilities.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.train import checkpoint as JC
from eyediseasesegmentation_tpu.train import gan as JG
from eyediseasesegmentation_tpu_torch.convert import (flax_to_torch, load_gan,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.data import (OneLesionSegmentation,
                                                   get_datapath)
from eyediseasesegmentation_tpu_torch.data.synthetic import make_idrid_tree
from eyediseasesegmentation_tpu_torch.train import gan as TG

CFG = {"image_size": 16, "patch_size": 8, "d_weight": 0.01,
       "generator": "classic_unet",
       "generator_params": {"filters": (4, 8), "classes": 1},
       "g_learning_rate": 1e-3, "d_learning_rate": 1e-3, "seg_loss": "bce",
       "mesh_shape": {"data": 1}}
RTOL = 1e-5            # the losses, relative
LEAF_TOL = 1e-5        # each leaf, of its largest magnitude
ADV_ATOL = CFG["d_weight"] * 2.0 ** -22
EXACT_TOL = 1e-4       # a leaf against the fp64 port, of its largest


def _paths(tree, prefix=()):
    """{key path: shape} of a nested mapping of arrays."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


@pytest.fixture(scope="module")
def jax_gan():
    """The JAX trainer, its initial state (host copies) and the tree of
    key paths and shapes its ``best_gan.ckpt`` holds."""
    tr = JG.GanTrainer(dict(CFG))
    state = jax.tree_util.tree_map(np.asarray, tr.init(jax.random.PRNGKey(3)))
    g_params, g_bs, d_params = state[:3]
    shapes = {"g_state_dict": _paths(g_params),
              "g_batch_stats": _paths(g_bs), "d_state_dict": _paths(d_params)}
    return tr, state, shapes


def test_image_to_patch_matches_jax():
    x = np.random.RandomState(0).randn(2, 19, 21, 3).astype(np.float32)
    want = np.asarray(JG.image_to_patch(jnp.asarray(x), 8))
    got = TG.image_to_patch(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    assert got.shape == (2 * 2 * 2, 3, 8, 8)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_dnet_matches_jax():
    x = np.random.RandomState(1).rand(5, 12, 12, 3).astype(np.float32)
    d = JG.DNet()
    variables = jax.jit(d.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(d.apply)(variables, jnp.asarray(x)))
    port = TG.DNet()
    port.load_state_dict(flax_to_torch({"params": variables["params"]}))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert _paths(torch_to_flax(port)["params"]) == _paths(
        variables["params"])


def _port_step(state, imgs, masks, dtype):
    """The port's step from the JAX weights in ``dtype``: the losses and
    the new state of G and D (D's keys prefixed ``D.``), in fp64."""
    port = TG.GanTrainer(dict(CFG), device="cpu")
    load_gan(port.generator, port.discriminator,
             {"g_state_dict": state[0], "g_batch_stats": state[1],
              "d_state_dict": state[2]})
    if dtype == torch.float64:
        for model in (port.generator, port.discriminator):
            model.double()
            for mod in model.modules():
                if hasattr(mod, "dtype"):
                    mod.dtype = dtype
        port.dtype = dtype
    losses = {k: float(v) for k, v in port.train_step(imgs, masks).items()}
    new = {**port.generator.state_dict(),
           **{f"D.{k}": v for k, v in port.discriminator.state_dict().items()}}
    return losses, {k: v.double() for k, v in new.items()}


def test_gan_step_matches_jax(jax_gan):
    tr, state, _ = jax_gan
    rng = np.random.RandomState(5)
    imgs = (rng.rand(4, 16, 16, 3) * 255).astype(np.float32)
    masks = (rng.rand(4, 16, 16) < 0.2).astype(np.float32)
    got, have = _port_step(state, imgs, masks, torch.float32)
    _, exact = _port_step(state, imgs, masks, torch.float64)
    copies = jax.tree_util.tree_map(jnp.array, state)   # _step donates
    *new, m = tr._step(*copies, jnp.asarray(imgs), jnp.asarray(masks),
                       jax.random.PRNGKey(4))
    for k in ("d_loss", "g_loss", "seg", "adv"):
        np.testing.assert_allclose(got[k], float(m[k]), rtol=RTOL,
                                   atol=ADV_ATOL if k == "adv" else 0,
                                   err_msg=k)
    new_g, new_bs, new_d = (jax.tree_util.tree_map(np.asarray, t)
                            for t in new[:3])
    want = {**flax_to_torch({"params": new_g, "batch_stats": new_bs}),
            **{f"D.{k}": v for k, v in
               flax_to_torch({"params": new_d}).items()}}
    assert set(have) == set(want) == set(exact)
    jax_to_exact = []
    for k, v in want.items():
        v = v.double()
        top = max(float(v.abs().max()), 1e-30)
        jax_to_exact.append(float((v - exact[k]).abs().max()) / top)
        if float((have[k] - v).abs().max()) <= LEAF_TOL * top:
            continue
        assert float((have[k] - exact[k]).abs().max()) <= EXACT_TOL * top, k
    assert np.median(jax_to_exact) <= LEAF_TOL


def test_gan_fit_writes_the_jax_tree(jax_gan, tmp_path):
    make_idrid_tree(tmp_path / "data", lesion_type="SE", n_train=4,
                    n_test=2, size=(32, 32))
    imgs, masks = get_datapath(tmp_path / "data" / "train" / "image",
                               tmp_path / "data" / "train" / "mask", "SE")
    ds = OneLesionSegmentation(imgs, masks)
    cfg = dict(CFG, image_size=32, num_epochs=2, eval_every=2)
    trainer = TG.GanTrainer(cfg, logdir=tmp_path / "gan", device="cpu")
    result = trainer.fit(ds, ds, batch_size=2)
    rows = [json.loads(ln) for ln in
            (tmp_path / "gan" / "gan_metrics.jsonl").read_text().splitlines()]
    assert rows == result["history"] and len(rows) == 2
    assert set(rows[0]) == {"epoch", "d_loss", "g_loss", "seg", "adv", "time"}
    assert set(rows[1]) == set(rows[0]) | {"val_ap"}
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("d_loss", "g_loss", "seg", "adv"))
    assert 0.0 <= result["best_ap"] <= 1.0
    tree = JC.load_checkpoint(tmp_path / "gan" / "best_gan.ckpt")
    assert int(tree["epoch"]) == 1 and int(tree["step"]) == 4
    for key, shapes in jax_gan[2].items():
        assert _paths(tree[key]) == shapes, key
    fresh = TG.GanTrainer(cfg, seed=7, device="cpu")
    assert fresh.load_checkpoint(tmp_path / "gan" / "best_gan.ckpt") == {
        "epoch": 1, "step": 4}
    batch = np.stack([ds[i]["image"] for i in range(2)])
    torch.testing.assert_close(fresh.predict_probs(batch),
                               trainer.predict_probs(batch), rtol=0, atol=0)


def test_gan_refuses_data_parallel():
    """Two data ranks on a one-rank job (tests/test_torch_data_parallel.py
    trains on two)."""
    with pytest.raises(ValueError, match="covers 2 ranks, but the job has 1"):
        TG.GanTrainer(dict(CFG, mesh_shape={"data": 2}), device="cpu")


def _fit_twice(trainer, ds, logdir, read, **kw):
    """Two ``fit`` calls on one trainer: each one's history without its
    times, and the ``best_gan.ckpt`` each leaves (read with ``read``)."""
    out = []
    for _ in range(2):
        hist = trainer.fit(ds, ds, **kw)["history"]
        out.append(([{k: v for k, v in r.items() if k != "time"}
                     for r in hist],
                    read(logdir / "best_gan.ckpt")))
    return out


def test_second_fit_restarts_as_in_jax(jax_gan, tmp_path):
    """A second ``fit`` on the same trainer draws the weights, the Adam
    states and the step count anew, in JAX and in the port: both give the
    first fit's history and ``best_gan.ckpt`` again, bit for bit."""
    make_idrid_tree(tmp_path / "data", lesion_type="SE", n_train=4,
                    n_test=0, size=(16, 16))
    ds = OneLesionSegmentation(*get_datapath(
        tmp_path / "data" / "train" / "image",
        tmp_path / "data" / "train" / "mask", "SE"))
    cfg = dict(CFG, num_epochs=2)         # evaluated at the last epoch
    leaves = lambda tree: {k: np.asarray(v) for k, v in _flat(tree).items()}
    port = TG.GanTrainer(cfg, logdir=tmp_path / "port", device="cpu")
    (h1, c1), (h2, c2) = _fit_twice(port, ds, tmp_path / "port",
                                    lambda p: leaves(JC.load_checkpoint(p)),
                                    batch_size=4)
    assert h1 == h2 and len(h1) == 2 and int(c2[("step",)]) == 2
    assert c1.keys() == c2.keys()
    for k in c1:
        np.testing.assert_array_equal(c1[k], c2[k], err_msg=str(k))
    tr = jax_gan[0]                      # its step is compiled at batch 4
    tr.logdir = tmp_path / "jax"
    (j1, d1), (j2, d2) = _fit_twice(tr, ds, tmp_path / "jax",
                                    lambda p: leaves(JC.load_checkpoint(p)),
                                    num_epochs=2, batch_size=4)
    assert j1 == j2 and [set(r) for r in j1] == [set(r) for r in h1]
    assert int(d2[("step",)]) == 2
    for k in d1:
        np.testing.assert_array_equal(d1[k], d2[k], err_msg=str(k))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
