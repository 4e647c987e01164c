"""Port parity: multi-checkpoint ensemble inference (``infer/ensemble.py``
and the ``python -m eyediseasesegmentation_tpu_torch.ensemble`` driver)
against the JAX package, and the size-changing TTA aliases on a real
size-free model.

Three run directories written by the JAX package's ``save_checkpoint``
(``config.json`` with ``inference_dtype`` float32 at ``scale_size`` 64,
flax variables from numpy seeds): ``classic_unet`` at two seeds and
``resnet18_unet32``. On the JAX package's synthetic IDRiD tree (3 test
images of 48×64, so batch 2 pads its second batch) both packages' ensembles
run on the same run directories, the two ``classic_unet`` seeds through the
drivers and the heterogeneous pair through ``predict``: the ensemble's
probabilities within 1e-6, ``mean_auc`` and the thresholds equal, the mask
files byte for byte. ``multiscale``, ``five_crop`` and ``ten_crop`` hold the
port's ``TTAPredictor`` to JAX's on ``classic_unet`` (probabilities within
1e-5).
"""

import importlib.util
import json
import logging
import shutil
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.data.synthetic import make_idrid_tree
from eyediseasesegmentation_tpu.infer import ensemble as jensemble
from eyediseasesegmentation_tpu.infer import tta as jtta
from eyediseasesegmentation_tpu.train.checkpoint import save_checkpoint
from eyediseasesegmentation_tpu_torch import ensemble as tdriver
from eyediseasesegmentation_tpu_torch.infer import ensemble as tensemble
from eyediseasesegmentation_tpu_torch.infer import tta as ttta

from test_torch_zoo import random_variables

REPO = Path(__file__).resolve().parents[1]
SCALE = 64
ORI = (48, 64)
RUNS = {"unet_a": ("classic_unet", {"filters": [8, 16, 32]}, 3),
        "unet_b": ("classic_unet", {"filters": [8, 16, 32]}, 4),
        "resnet18": ("resnet18_unet32",
                     {"decoder_channels": [32, 16, 16, 8, 8]}, 5)}


def write_run(root: Path, tag: str) -> Path:
    """``root/models/IDRiD/EX/<tag>``: config.json and ``best.ckpt``,
    written by the JAX package."""
    name, params, seed = RUNS[tag]
    logdir = root / "models" / "IDRiD" / "EX" / tag
    (logdir / "checkpoints").mkdir(parents=True)
    (logdir / "config.json").write_text(json.dumps({
        "model_name": name, "model_params": params, "dataset_name": "IDRiD",
        "lesion_type": "EX", "scale_size": SCALE,
        "inference_dtype": "float32"}))
    model = jzoo.get_model(name, params, training=False)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SCALE, SCALE, 3), jnp.float32))
    save_checkpoint(logdir / "checkpoints" / "best.ckpt",
                    {"model_state_dict": random_variables(shapes, seed),
                     "metric": 0.5, "epoch": 1})
    return logdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble")
    make_idrid_tree(root / "data", lesion_type="EX", n_train=0, n_test=3,
                    size=ORI)
    test = {"test_img_path": str(root / "data" / "test" / "image"),
            "test_mask_path": str(root / "data" / "test" / "label"),
            "lesion_type": "EX"}
    yield {"root": root, "test": test,
           **{tag: write_run(root, tag) for tag in RUNS}}
    shutil.rmtree(root / "models")       # the resnet18 run is 45 MB


@pytest.fixture
def captured(monkeypatch):
    """Each package's ensemble probabilities, as its ``predict`` hands them
    to the mask export."""
    out = {}

    def capture(pkg, module):
        real = module.export_masks_on_device

        def export(batches, *args, **kw):
            batches = list(batches)
            out[pkg] = np.concatenate([np.asarray(
                p.cpu() if isinstance(p, torch.Tensor) else p)[:len(n)]
                for p, n in batches])
            return real(batches, *args, **kw)
        monkeypatch.setattr(module, "export_masks_on_device", export)

    capture("jax", jensemble)
    capture("port", tensemble)
    return out


def _hold(got, want, probs, out):
    assert probs["port"].shape == probs["jax"].shape == (3, *ORI)
    np.testing.assert_allclose(probs["port"], probs["jax"], rtol=0,
                               atol=1e-6)
    assert got["mean_auc"] == pytest.approx(want["mean_auc"], abs=1e-6)
    assert 0.0 <= got["mean_auc"] <= 1.0
    for k in ("optimal_threshold", "optimal_threshold_1",
              "optimal_threshold_2"):
        assert got["thresholds"][k] == want["thresholds"][k], k
    names = sorted(p.name for p in Path(want["out_dir"]).iterdir())
    assert names == ["IDRiD_te00.jpg", "IDRiD_te01.jpg", "IDRiD_te02.jpg"]
    assert sorted(p.name for p in Path(got["out_dir"]).iterdir()) == names
    for n in names:
        assert ((Path(got["out_dir"]) / n).read_bytes()
                == (Path(want["out_dir"]) / n).read_bytes()), n
    assert (out / "figures").is_dir()


def _root_ensemble():
    spec = importlib.util.spec_from_file_location("root_ensemble",
                                                  REPO / "ensemble.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_matches_root_driver(runs, captured, monkeypatch):
    """Two seeds of classic_unet through both drivers' flags."""
    root = runs["root"]
    overrides = root / "overrides.json"
    overrides.write_text(json.dumps({**runs["test"], "scale_size": SCALE}))
    argv = ["--logdirs", str(runs["unet_a"]), str(runs["unet_b"]),
            "--tta", "d4", "--batch_size", "2", "--config", str(overrides)]
    root_driver, results = _root_ensemble(), []
    real = root_driver.predict
    monkeypatch.setattr(root_driver, "predict",
                        lambda *a, **k: results.append(real(*a, **k)))
    monkeypatch.setattr(sys, "argv", ["ensemble.py", "--out",
                                      str(root / "jax_out")] + argv)
    root_driver.main()
    got = tdriver.main(argv + ["--out", str(root / "port_out"),
                               "--device", "cpu"])
    _hold(got, results[0], captured, root / "port_out")
    assert got["out_dir"] == str(root / "port_out" / "masks")
    logging.getLogger().handlers.clear()   # root ensemble.py's basicConfig


def test_heterogeneous_predict_matches_jax(runs, captured):
    """classic_unet beside resnet18_unet32: each member rebuilt from its
    own config.json."""
    root, config = runs["root"], runs["test"]
    logdirs = [runs["unet_a"], runs["resnet18"]]
    want = jensemble.predict(config, logdirs, root / "jax_het", tta="d4",
                             batch_size=2)
    got = tensemble.predict(config, logdirs, root / "port_het", tta="d4",
                            batch_size=2, device="cpu")
    _hold(got, want, captured, root / "port_het")
    members = tensemble.get_best_models(logdirs, ori_hw=ORI, device="cpu")
    assert [type(p.model).__name__ for p in members] == ["ClassicUNet",
                                                        "Unet"]


def test_sharded_ensemble_raises(runs):
    """One member per rank: two members on a one-rank job raise JAX's
    ``ValueError`` in the driver, ``predict`` and ``make_sharded_ensemble``
    (tests/test_torch_sharded_infer.py runs them on two ranks)."""
    from eyediseasesegmentation_tpu_torch.parallel import make_mesh
    logdirs = [str(runs["unet_a"]), str(runs["unet_b"])]
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="2 members > 1 devices"):
        tdriver.main(["--logdirs", *logdirs, "--sharded", "--device", "cpu"])
    with pytest.raises(ValueError, match="2 members > 1 devices"):
        tensemble.predict(runs["test"], logdirs, runs["root"] / "x",
                          mesh=mesh, device="cpu")
    members = tensemble.get_best_models(logdirs, ori_hw=ORI, device="cpu")
    with pytest.raises(ValueError, match="2 members > 1 devices"):
        tensemble.make_sharded_ensemble(members, mesh)


def test_driver_flags():
    args = tdriver.parse_arg(["--logdirs", "a", "b"])
    assert vars(args) == {"logdirs": ["a", "b"], "out": "outputs/ensemble",
                          "tta": "d4", "batch_size": 2, "config": None,
                          "sharded": False, "device": None}
    with pytest.raises(SystemExit):
        tdriver.parse_arg([])


@pytest.mark.parametrize("tta", ["multiscale", "five_crop", "ten_crop"])
def test_size_changing_aliases_match_jax_on_classic_unet(tta, runs):
    raw = np.random.RandomState(6).randint(0, 256, (2, *ORI, 3)).astype(
        np.uint8)
    jmodel, variables, cfg = jtta.load_model_for_inference(runs["unet_a"])
    want = jtta.TTAPredictor(jmodel, variables, cfg, tta=tta,
                             ori_hw=ORI).predict(raw)
    tmodel, cfg = ttta.load_model_for_inference(runs["unet_a"], device="cpu")
    got = ttta.TTAPredictor(tmodel, cfg, tta=tta, ori_hw=ORI).predict(raw)
    assert got.shape == (2, *ORI)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
