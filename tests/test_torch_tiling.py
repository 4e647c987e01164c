"""Port parity: tiled inference (``make_grid``, ``tiled_predict``,
``tta_patches``, ``evaluate --tiled``) and the ``multiscale`` /
``five_crop`` / ``ten_crop`` TTA aliases against the JAX package.

Every JAX call here that reaches the flagship goes through one compiled
batch-1 forward: ``TTAPredictor._forward`` of the JAX package is replaced,
for the tests that ask for the ``jax_forward`` fixture, by a
``jax.pure_callback`` into the jitted flagship (``test_torch_flagship``'s
weights, which the run directory holds), one image at a time and memoised
on the image's bytes, so that JAX's tiled passes compile the flagship once
and see each tile once. Everything else of the JAX functions runs as it is.

The run directory is test_torch_test_tta's (fp32 flagship at ``base_dim=2``,
scale 64) over 2 synthetic IDRiD test images of 128×160: windows of 128
with 32 px overlap, 4 tiles an image, each resized 2:1 with antialiasing to
64² (the 2048 → 1024 geometry of the full-size path) and back. Tolerances:
1e-5 for a local model, 1e-4 for the flagship's probabilities, mean AUC
within 1e-4, thresholds equal, masks equal except where the port's
probability lies within 1e-4 of the chosen threshold, ``evaluate``'s
4-decimal table within one unit of its last place.
"""

import functools
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
import torch.nn.functional as F
from PIL import Image

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.data.synthetic import make_idrid_tree
from eyediseasesegmentation_tpu.infer import tta as jtta
from eyediseasesegmentation_tpu.ops.tiling import (
    tiled_predict as jtiled_predict)
from eyediseasesegmentation_tpu.utils import make_grid as jmake_grid
from eyediseasesegmentation_tpu_torch import evaluate as tevaluate
from eyediseasesegmentation_tpu_torch.infer import tta as ttta
from eyediseasesegmentation_tpu_torch.ops.tiling import tiled_predict
from eyediseasesegmentation_tpu_torch.utils import make_grid

from test_torch_flagship import BASE_DIM, jax_flagship, torch_flagship
from test_torch_test_tta import write_run_dir

REPO = Path(__file__).resolve().parents[1]
SCALE = 32 * BASE_DIM
ORI = (128, 160)
NEAR = 1e-4
CONFIG = {"dataset_name": "IDRiD", "gray": False, "scale_size": SCALE}

_MEMO = {}
# one port flagship for the file (eval mode holds no state between calls)
port_flagship = functools.lru_cache(maxsize=None)(torch_flagship)


def _jax_logits(x):
    """The JAX flagship's logits (N, S, S) of an fp32 (N, S, S, 3) batch,
    image by image through the batch-1 executable."""
    _, variables, apply = jax_flagship()
    out = []
    for im in np.asarray(x, np.float32):
        key = (im.shape, im.tobytes())
        if key not in _MEMO:
            _MEMO[key] = np.asarray(apply(variables, im[None]))[0, ..., 0]
        out.append(_MEMO[key])
    return np.stack(out)


def _callback_forward(self, images, variables=None):
    return jax.pure_callback(
        _jax_logits, jax.ShapeDtypeStruct(images.shape[:3], jnp.float32),
        images.astype(jnp.float32))


@pytest.fixture
def jax_forward(monkeypatch):
    monkeypatch.setattr(jtta.TTAPredictor, "_forward", _callback_forward)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiled_run")
    logdir = write_run_dir(root)
    make_idrid_tree(root / "data", lesion_type="EX", n_train=0, n_test=2,
                    size=ORI)
    test = {"test_img_path": str(root / "data" / "test" / "image"),
            "test_mask_path": str(root / "data" / "test" / "label")}
    yield {"root": root, "logdir": logdir, "test": test}
    shutil.rmtree(logdir / "checkpoints")     # the flagship's 230 MB


@pytest.mark.parametrize("shape,window,overlap", [
    ((2848, 4288), 2048, 32), ((584, 565), 256, 32), (ORI, 128, 32),
    ((64, 96), 64, 32)])
def test_make_grid_matches_jax(shape, window, overlap):
    got = make_grid(shape, window, overlap)
    np.testing.assert_array_equal(got, jmake_grid(shape, window, overlap))
    if shape == (2848, 4288):   # the full-size lesion path: 6 windows
        assert got.shape == (6, 4)


def _local_weights():
    return np.random.RandomState(7).uniform(-0.01, 0.01, (3, 3, 3, 1)
                                            ).astype(np.float32)


def _jax_local(x):
    """A 3×3 conv: tile seams, crops and flips all show in its output."""
    return jax.lax.conv_general_dilated(
        x, jnp.asarray(_local_weights()), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) - 0.5


class LocalModel(torch.nn.Module):
    """The port's counterpart of ``_jax_local`` (NCHW in and out)."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.from_numpy(_local_weights()).permute(3, 2, 0, 1))

    def forward(self, x):
        return F.conv2d(x, self.w, padding=1) - 0.5


class JaxLocalModel:
    def apply(self, variables, x, train=False):
        return _jax_local(x)


@pytest.mark.parametrize("blend", ["overwrite", "mean"])
@pytest.mark.parametrize("shape,scale", [(ORI, SCALE), ((96, 150), 64),
                                         ((70, 70), 80)])
def test_tiled_predict_local_matches_jax(shape, scale, blend):
    """2:1, 96 → 64 and 70 → 80 tile resizes; every blend."""
    window = min(2 * scale, *shape)
    grid = make_grid(shape, window, 32)
    img = np.random.RandomState(1).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    want = jax.jit(partial(
        jtiled_predict, lambda t: jax.nn.sigmoid(_jax_local(t[None] / 255.0)
                                                 [0, ..., 0]),
        window=window, scale_size=scale, blend=blend))(jnp.asarray(img),
                                                       jnp.asarray(grid))
    model = LocalModel()
    got = tiled_predict(
        lambda t: torch.sigmoid(model((t / 255.0).permute(2, 0, 1)[None])
                                [0, 0]),
        torch.from_numpy(img), grid, window, scale, blend=blend)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("blend", ["overwrite", "mean"])
def test_tiled_predict_flagship_matches_jax(blend, jax_forward):
    model, variables, _ = jax_flagship()
    engine = jtta.TTAPredictor(model, variables, CONFIG, tta="none",
                               resize=False)
    prep = engine.transform.preprocessing_fn
    window = min(2 * SCALE, *ORI)
    grid = make_grid(ORI, window, 32)
    img = np.random.RandomState(2).randint(0, 256, ORI + (3,)).astype(
        np.uint8)
    want = jax.jit(partial(
        jtiled_predict, lambda t: engine._tta_probs(prep(t)[None])[0],
        window=window, scale_size=SCALE, blend=blend))(jnp.asarray(img),
                                                       jnp.asarray(grid))
    port = ttta.TTAPredictor(port_flagship(), CONFIG, tta="none",
                             resize=False)
    with torch.inference_mode():
        got = tiled_predict(port.predict_tile, torch.from_numpy(img), grid,
                            window, SCALE, blend=blend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _decoded(path):
    return np.asarray(Image.open(path).convert("L")).astype(np.int16)


@pytest.mark.parametrize("metric", ["pr", "roc"])
def test_tta_patches_matches_jax(run, metric, jax_forward, monkeypatch,
                                 tmp_path):
    seen = []
    export = ttta.export_masks_on_device

    def capture(batches, optim, out_path, prob_path=None):
        batches = list(batches)
        seen.extend((names[0], p.numpy()) for p, names in batches)
        return export(batches, optim, out_path, prob_path)

    monkeypatch.setattr(ttta, "export_masks_on_device", capture)
    args = {"tta": "hflip"}
    out = {}
    for name, fn, kw in (("jax", jtta.tta_patches, {}),
                         ("port", ttta.tta_patches, {"device": "cpu"})):
        cfg = {**run["test"], "out_dir": str(tmp_path / name)}
        out[name] = fn(run["logdir"], cfg, args, metric=metric, **kw)
    assert abs(out["port"]["mean_auc"] - out["jax"]["mean_auc"]) <= 1e-4
    assert np.isfinite(out["port"]["mean_auc"])
    for k in ("optimal_threshold", "optimal_threshold_1",
              "optimal_threshold_2"):
        assert out["port"]["thresholds"][k] == out["jax"]["thresholds"][k]
    t = out["port"]["thresholds"]["optimal_threshold_2"]
    # the IDRiD names lose their lesion suffix; no prob_image here
    assert sorted(n for n, _ in seen) == ["IDRiD_te00.jpg", "IDRiD_te01.jpg"]
    near_total = differ_total = 0
    for name, p in seen:
        got = _decoded(Path(out["port"]["out_dir"]) / name) > 127
        want = _decoded(Path(out["jax"]["out_dir"]) / name) > 127
        assert got.shape == want.shape == ORI == p.shape
        near = np.abs(p - t) <= NEAR
        near_total += int(near.sum())
        differ_total += int((got != want).sum())
        assert not (got != want)[~near].any(), name
    assert differ_total <= near_total
    assert not (tmp_path / "port" / "IDRiD" / "tta" / "EX" /
                "prob_image").exists()


def test_tiled_pass_refuses_mixed_sizes():
    """The grid is built for the first image; another size raises before
    it is predicted."""
    model = LocalModel()
    engine = ttta.TTAPredictor(model, CONFIG, tta="hflip", resize=False)
    rng = np.random.RandomState(3)
    ds = [{"image": rng.randint(0, 256, hw + (3,)).astype(np.uint8),
           "mask": np.zeros(hw, np.float32), "filename": f"{i}.jpg",
           "ori_h": hw[0], "ori_w": hw[1]}
          for i, hw in enumerate([(80, 96), (80, 90)])]
    grid = make_grid((80, 96), 80, 32)
    with pytest.raises(ValueError, match="mixed-size"):
        ttta.tiled_pass(engine, ds, grid, 80, SCALE)
    totals, probs = ttta.tiled_pass(engine, ds[:1], grid, 80, SCALE,
                                    metric="roc")
    assert [p.shape for p, _ in probs] == [(80, 96)]
    assert float(totals["px"]) == 80 * 96


def _root_evaluate():
    spec = importlib.util.spec_from_file_location("root_evaluate",
                                                  REPO / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_tiled_matches_root_evaluate(run, jax_forward,
                                              monkeypatch):
    overrides = run["root"] / "overrides.json"
    overrides.write_text(json.dumps({**run["test"], "scale_size": SCALE,
                                     "lesion_type": "EX"}))
    argv = ["--logdir", str(run["logdir"]), "--config", str(overrides),
            "--tiled", "--tta", "hflip", "--threshold", "0.45"]
    root_eval = _root_evaluate()
    tables = []
    monkeypatch.setattr(root_eval, "log_pretty_table",
                        lambda cols, rows: tables.append((cols, rows)))
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    root_eval.main()
    (cols, want), = tables
    got = tevaluate.main(argv + ["--device", "cpu"])
    assert cols == tevaluate.COLUMNS
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, float):
                # rounded to 4 decimals: one unit of the last place
                assert abs(a - b) <= 1e-4 + 1e-9, (g, w)
            else:
                assert a == b, (g, w)
    logging.getLogger().handlers.clear()   # root evaluate.py's basicConfig


def test_multiscale_flagship_tiled_legs_match_jax(jax_forward):
    """``multiscale_max_res=scale_size``: every leg above scale 1 runs as
    s² tiles of 64² (1 + 4 + 16 forwards), so the fixed-size flagship
    takes it."""
    model, variables, _ = jax_flagship()
    raw = np.random.RandomState(4).randint(0, 256, (1, 80, 112, 3)).astype(
        np.uint8)
    want = jtta.TTAPredictor(model, variables, CONFIG, tta="multiscale",
                             ori_hw=raw.shape[1:3],
                             multiscale_max_res=SCALE).predict(raw)
    got = ttta.TTAPredictor(port_flagship(), CONFIG, tta="multiscale",
                            ori_hw=raw.shape[1:3],
                            multiscale_max_res=SCALE).predict(raw)
    assert got.shape == (1, 80, 112)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("tta,max_res", [
    pytest.param("multiscale", 2048, id="multiscale_monolithic"),
    pytest.param("multiscale", 32, id="multiscale_tiled"),
    pytest.param("five_crop", 2048, id="five_crop"),
    pytest.param("ten_crop", 2048, id="ten_crop")])
def test_size_free_aliases_match_jax(tta, max_res):
    """On a local model, which takes any size: the monolithic multiscale
    legs (64² and 128² forwards), the tiled ones and the crops."""
    cfg = dict(CONFIG, scale_size=32)
    raw = np.random.RandomState(5).randint(0, 256, (2, 40, 48, 3)).astype(
        np.uint8)
    want = jtta.TTAPredictor(JaxLocalModel(), {}, cfg, tta=tta,
                             ori_hw=(40, 48),
                             multiscale_max_res=max_res).predict(raw)
    got = ttta.TTAPredictor(LocalModel(), cfg, tta=tta, ori_hw=(40, 48),
                            multiscale_max_res=max_res).predict(raw)
    assert got.shape == (2, 40, 48)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
