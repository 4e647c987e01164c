"""Sharded inference on two gloo ranks against the JAX package at
``{"data": 2}``.

One 2-rank group (``parallel.mesh.spawn``, CPU) runs every case; the parent
computes the JAX references (its 8-device CPU mesh, the first two devices)
and the port's unsharded ones. The ranks import this file but not JAX.

* ``TTAPredictor(mesh=...)``: the fused d4 view batch split over the ranks,
  ``classic_unet`` at filters (8, 16) on a 32² image, to 1e-5;
* ``tiled_predict_sharded`` in both blends (15 tiles: the grid is padded),
  to 1e-5;
* ``make_sharded_ensemble`` with two members and with one (rank 1 a
  zero-weight repeat), to 1e-5, and its ``ValueError``s;
* ``tta_patches(mesh=...)`` against the port's unsharded ``tta_patches`` on
  a run directory the port writes, and ``infer.ensemble.predict(mesh=...)``
  (each rank loads its own member) against the unsharded ``predict`` on
  two: the same scores and masks.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch import models as zoo
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.infer import ensemble as tensemble
from eyediseasesegmentation_tpu_torch.infer.ensemble import (
    make_sharded_ensemble)
from eyediseasesegmentation_tpu_torch.infer.tta import (TTAPredictor,
                                                        tta_patches)
from eyediseasesegmentation_tpu_torch.ops.tiling import tiled_predict_sharded
from eyediseasesegmentation_tpu_torch.parallel import mesh as P
from eyediseasesegmentation_tpu_torch.utils import make_grid

WORLD, S = 2, 32
TOL = 1e-5
UNET = {"filters": (8, 16)}
CFG = {"dataset_name": "IDRiD", "gray": False, "scale_size": S}
IMAGE = (np.random.RandomState(0).rand(1, S, S, 3) * 255).astype(np.float32)
TILE_IMAGE = np.random.RandomState(3).rand(70, 100, 3).astype(np.float32)
TILE_W1 = np.random.RandomState(4).randn(3).astype(np.float32)
WINDOW, TILE_SCALE = 32, 16
TEST_CONFIG = {"test_img_path": "data/test/image",
               "test_mask_path": "data/test/label", "scale_size": S,
               "lesion_type": "EX", "dataset_name": "IDRiD"}


def unet(seed):
    model = zoo.get_model("classic_unet", UNET, training=False,
                          device="cpu")
    return zoo.init_random(model, torch.Generator().manual_seed(seed))


def _tile_fn(tile):
    return torch.sigmoid(tile @ torch.from_numpy(TILE_W1) - 0.3)


def write_run(root: Path, name: str = "port", seed: int = 7) -> Path:
    """A port-written run directory (classic_unet, fp32, weights of
    ``seed``) and a synthetic IDRiD test tree of 3 images of 96×128 beside
    it."""
    from eyediseasesegmentation_tpu_torch.data.synthetic import (
        make_idrid_tree)
    from eyediseasesegmentation_tpu_torch.train.checkpoint import (
        save_checkpoint)
    if not (root / "data").exists():
        make_idrid_tree(root / "data", lesion_type="EX", n_train=0,
                        n_test=3, size=(96, 128))
    run = root / "models" / "IDRiD" / "EX" / name
    (run / "checkpoints").mkdir(parents=True)
    json.dump({"model_name": "classic_unet", "model_params": UNET,
               "scale_size": S, "lesion_type": "EX", "dataset_name": "IDRiD",
               "inference_dtype": "float32"}, open(run / "config.json", "w"))
    save_checkpoint(run / "checkpoints" / "best.ckpt",
                    {"model_state_dict": torch_to_flax(unet(seed))})
    return run


def _test_config(root: Path, tag: str):
    return {**TEST_CONFIG, "out_dir": str(root / tag),
            "test_img_path": str(root / "data/test/image"),
            "test_mask_path": str(root / "data/test/label")}


def patches(root: Path, mesh, tag: str):
    return tta_patches(root / "models/IDRiD/EX/port",
                       _test_config(root, tag), {"tta": "flip"},
                       device="cpu", mesh=mesh)


def ensemble(root: Path, mesh, tag: str):
    runs = [root / "models/IDRiD/EX" / n for n in ("port", "port2")]
    return tensemble.predict(_test_config(root, tag), runs, root / tag,
                             tta="flip", batch_size=2, mesh=mesh,
                             device="cpu")


def _ranks(mesh, out, root):
    torch.set_num_threads(2)
    res = {}
    for tta in ("d4", "flip"):
        res[f"tta_{tta}"] = TTAPredictor(unet(1), CFG, tta=tta,
                                         ori_hw=(S, S), mesh=mesh).predict(
            IMAGE)
    try:
        TTAPredictor(unet(1), CFG, tta="none", ori_hw=(S, S),
                     mesh=mesh).predict(IMAGE)
    except ValueError as e:
        res["tta_error"] = str(e)
    grid = make_grid(TILE_IMAGE.shape[:2], window=WINDOW, min_overlap=8)
    with torch.inference_mode():
        for blend in ("overwrite", "mean"):
            res[f"tiled_{blend}"] = tiled_predict_sharded(
                _tile_fn, torch.from_numpy(TILE_IMAGE), grid, WINDOW,
                TILE_SCALE, mesh, blend=blend)
    members = [TTAPredictor(unet(10 + i), CFG, tta="d4", ori_hw=(S, S))
               for i in range(2)]
    res["ensemble_2"] = make_sharded_ensemble(members, mesh).predict(IMAGE)
    res["ensemble_1"] = make_sharded_ensemble(members[:1], mesh).predict(
        IMAGE)
    other = TTAPredictor(unet(12), dict(CFG, scale_size=2 * S), tta="d4")
    try:
        make_sharded_ensemble([members[0], other], mesh)
    except ValueError as e:
        res["ensemble_error"] = str(e)
    result = patches(Path(root), mesh, "sharded")
    res["patches"] = {k: result[k] for k in ("mean_auc", "thresholds")}
    result = ensemble(Path(root), mesh, "ens_sharded")
    res["ensemble"] = {k: result[k] for k in ("mean_auc", "thresholds")}
    torch.save(res, f"{out}/rank{mesh.rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_infer")
    root = tmp_path_factory.mktemp("patches")
    write_run(root)
    write_run(root, "port2", 8)
    P.spawn(_ranks, WORLD, "cpu", str(out), str(root))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "root": root}


@pytest.fixture(scope="module")
def jax_side():
    import jax.numpy as jnp
    from eyediseasesegmentation_tpu import models as jzoo
    from eyediseasesegmentation_tpu.parallel import make_mesh
    mesh = make_mesh({"data": WORLD})
    return jzoo.get_model("classic_unet", UNET, training=False,
                          dtype=jnp.float32), mesh


@pytest.mark.parametrize("tta", ["d4", "flip"])
def test_sharded_tta_matches_jax(runs, jax_side, tta):
    from eyediseasesegmentation_tpu.infer.tta import TTAPredictor as JTTA
    model, mesh = jax_side
    want = np.asarray(JTTA(model, torch_to_flax(unet(1)), CFG, tta=tta,
                           ori_hw=(S, S), mesh=mesh).predict(IMAGE))
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[f"tta_{tta}"].numpy(), want,
                                   rtol=TOL, atol=TOL)


def test_sharded_tta_refuses_an_uneven_split(runs):
    for res in runs["ranks"]:
        assert "1 views × batch 1 = 1 forward images do not split over 2" \
            in res["tta_error"]


@pytest.mark.parametrize("blend", ["overwrite", "mean"])
def test_tiled_predict_sharded_matches_jax(runs, blend):
    import jax
    import jax.numpy as jnp
    from eyediseasesegmentation_tpu.ops.tiling import (
        tiled_predict_sharded as jtiled)
    from eyediseasesegmentation_tpu.parallel import make_mesh
    from eyediseasesegmentation_tpu.utils import make_grid as jgrid
    grid = jnp.asarray(jgrid((70, 100), window=WINDOW, min_overlap=8))
    assert grid.shape[0] % WORLD != 0          # the padding path
    w1 = jnp.asarray(TILE_W1)
    want = np.asarray(jtiled(lambda t: jax.nn.sigmoid(t @ w1 - 0.3),
                             jnp.asarray(TILE_IMAGE), grid, WINDOW,
                             TILE_SCALE, make_mesh({"data": WORLD}),
                             blend=blend))
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[f"tiled_{blend}"].numpy(), want,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("members", [2, 1])
def test_sharded_ensemble_matches_jax(runs, jax_side, members):
    from eyediseasesegmentation_tpu.infer.ensemble import (
        make_sharded_ensemble as jensemble)
    from eyediseasesegmentation_tpu.infer.tta import TTAPredictor as JTTA
    model, mesh = jax_side
    preds = [JTTA(model, torch_to_flax(unet(10 + i)), CFG, tta="d4",
                  ori_hw=(S, S)) for i in range(members)]
    want = np.asarray(jensemble(preds, mesh)(IMAGE))
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[f"ensemble_{members}"].numpy(), want,
                                   rtol=TOL, atol=TOL)


def test_sharded_ensemble_refuses_heterogeneous_members(runs):
    for res in runs["ranks"]:
        assert "member 1 differs from member 0" in res["ensemble_error"]


def test_tta_patches_sharded_matches_unsharded(runs):
    """The same scores on every rank as the unsharded pass, and rank 0's
    masks equal to the unsharded pass's files."""
    from PIL import Image
    root = runs["root"]
    want = patches(root, None, "unsharded")
    for res in runs["ranks"]:
        assert abs(res["patches"]["mean_auc"] - want["mean_auc"]) <= 1e-6
        assert res["patches"]["thresholds"] == want["thresholds"]
    masks = sorted((root / "unsharded").rglob("tta/EX/port/*.jpg"))
    assert len(masks) == 3
    for path in masks:
        other = root / "sharded" / path.relative_to(root / "unsharded")
        np.testing.assert_array_equal(np.asarray(Image.open(other)),
                                      np.asarray(Image.open(path)))


def test_ensemble_predict_sharded_matches_unsharded(runs):
    """``predict(mesh=...)``: one member per rank, the same scores on every
    rank as the unsharded ensemble, rank 0's masks its files."""
    from PIL import Image
    root = runs["root"]
    want = ensemble(root, None, "ens_unsharded")
    for res in runs["ranks"]:
        assert abs(res["ensemble"]["mean_auc"] - want["mean_auc"]) <= 1e-6
        assert res["ensemble"]["thresholds"] == want["thresholds"]
    masks = sorted((root / "ens_unsharded" / "masks").glob("*.jpg"))
    assert len(masks) == 3
    for path in masks:
        np.testing.assert_array_equal(
            np.asarray(Image.open(root / "ens_sharded" / "masks" / path.name)),
            np.asarray(Image.open(path)))
