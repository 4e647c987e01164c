"""Port parity: the whole-image pipeline (``test_tta``, ``evaluate``, the
paths and the test dataset) against the JAX package on one run directory.

One module-scoped run directory, written by the JAX package's own
``save_checkpoint``: the fp32 flagship at ``base_dim=2`` (shared with
test_torch_flagship.py) at ``scale_size`` 64, and a synthetic IDRiD tree of
3 test images of 96×128 (``data/synthetic.make_idrid_tree``), so batch 2
pads its second batch and the GT goes through the resize round trip. Both
``test_tta``s run once on it, d4 with ``createprob``: ``mean_auc`` within
1e-4, the three thresholds equal, the exported masks equal pixel for pixel
except where the port's probability lies within 1e-4 of the chosen
threshold (counted; no more may differ). ``evaluate``'s tables agree within
2e-4.
"""

import importlib.util
import json
import logging
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from eyediseasesegmentation_tpu.data import datasets as JD
from eyediseasesegmentation_tpu.data.paths import get_datapath as jget_datapath
from eyediseasesegmentation_tpu.data.synthetic import make_idrid_tree
from eyediseasesegmentation_tpu.infer.tta import test_tta as jtest_tta
from eyediseasesegmentation_tpu.train.checkpoint import save_checkpoint
from eyediseasesegmentation_tpu_torch import evaluate as tevaluate
from eyediseasesegmentation_tpu_torch.data import datasets as TD
from eyediseasesegmentation_tpu_torch.data.paths import get_datapath
from eyediseasesegmentation_tpu_torch.infer.tta import (
    TTAPredictor, load_model_for_inference, test_tta)

from test_torch_flagship import MODEL_PARAMS, jax_flagship

REPO = Path(__file__).resolve().parents[1]
SCALE = 64
ORI = (96, 128)
NEAR = 1e-4


def write_run_dir(root: Path) -> Path:
    """``root/models/IDRiD/EX/run``: config.json of the fp32 flagship at
    ``SCALE`` and its weights as ``checkpoints/best.ckpt``, written by the
    JAX package."""
    logdir = root / "models" / "IDRiD" / "EX" / "run"
    (logdir / "checkpoints").mkdir(parents=True)
    (logdir / "config.json").write_text(json.dumps({
        "model_name": "unetplusplusstar", "model_params": MODEL_PARAMS,
        "dataset_name": "IDRiD", "lesion_type": "EX", "scale_size": SCALE,
        "inference_dtype": "float32"}))
    _, variables, _ = jax_flagship()
    save_checkpoint(logdir / "checkpoints" / "best.ckpt",
                    {"model_state_dict": variables, "metric": 0.5,
                     "epoch": 1})
    return logdir


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The run directory, the test tree and both packages' test_tta
    results."""
    root = tmp_path_factory.mktemp("tta_run")
    logdir = write_run_dir(root)
    make_idrid_tree(root / "data", lesion_type="EX", n_train=0, n_test=3,
                    size=ORI)
    test = {"test_img_path": str(root / "data" / "test" / "image"),
            "test_mask_path": str(root / "data" / "test" / "label")}
    args = {"tta": "d4", "createprob": "true"}
    out = {}
    for name, fn, kw in (("jax", jtest_tta, {}),
                         ("port", test_tta, {"device": "cpu"})):
        cfg = {**test, "out_dir": str(root / name)}
        out[name] = fn(logdir, cfg, args, batch_size=2, **kw)
    yield {"root": root, "logdir": logdir, "test": test, **out}
    shutil.rmtree(logdir / "checkpoints")     # the flagship's 230 MB


def test_test_tta_scores_match_jax(run):
    jax_out, port_out = run["jax"], run["port"]
    assert abs(port_out["mean_auc"] - jax_out["mean_auc"]) <= 1e-4
    for k in ("optimal_threshold", "optimal_threshold_1",
              "optimal_threshold_2"):
        assert port_out["thresholds"][k] == jax_out["thresholds"][k], k
    assert abs(port_out["thresholds"]["aucpr"]
               - jax_out["thresholds"]["aucpr"]) <= 1e-4


def _port_probs(run):
    model, cfg = load_model_for_inference(run["logdir"], device="cpu")
    paths = get_datapath(Path(run["test"]["test_img_path"]),
                         Path(run["test"]["test_mask_path"]), "EX")
    ds = TD.TestSegmentation(paths[0])
    predictor = TTAPredictor(model, cfg, tta="d4", ori_hw=ORI)
    return {Path(ds.image_paths[i]).stem + ".jpg":
            predictor.predict(ds[i]["image"][None])[0].numpy()
            for i in range(len(ds))}


def _decoded(path):
    return np.asarray(Image.open(path).convert("L")).astype(np.int16)


def test_test_tta_masks_match_jax(run, tmp_path):
    t = run["port"]["thresholds"]["optimal_threshold_2"]
    probs = _port_probs(run)
    jdir, pdir = Path(run["jax"]["out_dir"]), Path(run["port"]["out_dir"])
    assert sorted(p.name for p in pdir.iterdir()) == sorted(probs)
    assert sorted(p.name for p in jdir.iterdir()) == sorted(probs)
    near_total = differ_total = 0
    for name, p in probs.items():
        got, want = _decoded(pdir / name) > 127, _decoded(jdir / name) > 127
        assert got.shape == want.shape == ORI
        near = np.abs(p - t) <= NEAR
        near_total += int(near.sum())
        differ_total += int((got != want).sum())
        assert not (got != want)[~near].any(), name
    assert differ_total <= near_total
    # the probability images (createprob) agree within JPEG's rounding
    for name in probs:
        got, want = (_decoded(Path(run[out]["out_dir"]).parent / "prob_image"
                              / run["logdir"].name / name)
                     for out in ("port", "jax"))
        assert got.shape == ORI and np.abs(got - want).max() <= 2, name
    # the export alone, at a threshold inside the probabilities' range: the
    # same probabilities give the same files
    from eyediseasesegmentation_tpu.infer.tta import (
        export_masks_on_device as jexport)
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        export_masks_on_device)
    batch = np.stack(list(probs.values()))
    names = list(probs)
    mid = float(np.median(batch))
    export_masks_on_device([(torch.from_numpy(batch), names)], mid,
                           tmp_path / "port", tmp_path / "port_p")
    jexport([(batch, names)], mid, tmp_path / "jax", tmp_path / "jax_p")
    for name in names:
        for sub in ("", "_p"):
            got = _decoded(tmp_path / f"port{sub}" / name)
            assert got.max() > 0
            np.testing.assert_array_equal(
                got, _decoded(tmp_path / f"jax{sub}" / name))


def _root_evaluate():
    spec = importlib.util.spec_from_file_location("root_evaluate",
                                                  REPO / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_matches_root_evaluate(run, monkeypatch):
    overrides = run["root"] / "overrides.json"
    # evaluate's TestConfig defaults override the run's config.json
    overrides.write_text(json.dumps({**run["test"], "scale_size": SCALE,
                                     "lesion_type": "EX"}))
    argv = ["--logdir", str(run["logdir"]), "--config", str(overrides)]
    root_eval = _root_evaluate()
    tables = []
    monkeypatch.setattr(root_eval, "log_pretty_table",
                        lambda cols, rows: tables.append((cols, rows)))
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    root_eval.main()
    (cols, want), = tables
    got = tevaluate.main(argv + ["--device", "cpu"])
    assert cols == tevaluate.COLUMNS
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, float):
                assert abs(a - b) <= 2e-4, (g, w)
            else:
                assert a == b, (g, w)
    logging.getLogger().handlers.clear()   # root evaluate.py's basicConfig


def test_paths_and_datasets_match_jax(run, monkeypatch):
    args = (Path(run["test"]["test_img_path"]),
            Path(run["test"]["test_mask_path"]), "EX")
    imgs, masks = get_datapath(*args)
    assert (imgs, masks) == jget_datapath(*args) and len(imgs) == 3
    kw = dict(metric_roundtrip_scale=SCALE)
    port_ds, jax_ds = (TD.TestSegmentation(imgs, masks, **kw),
                       JD.TestSegmentation(imgs, masks, **kw))
    assert len(port_ds) == len(jax_ds) == 3
    for i in range(3):
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for got, want in zip(TD.batch_iterator(port_ds, 2, workers=2),
                         JD.batch_iterator(jax_ds, 2, workers=2)):
        assert got.keys() == want.keys() and got["n_valid"] == want["n_valid"]
        for k in ("image", "mask", "ori_h"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # reference_gt_roundtrip: the cv2 path, then the numpy one
    mask = (np.random.RandomState(3).uniform(size=(37, 53)) < 0.2)
    mask = mask.astype(np.float32)
    for _ in range(2):
        np.testing.assert_array_equal(TD.reference_gt_roundtrip(mask, 32),
                                      JD.reference_gt_roundtrip(mask, 32))
        monkeypatch.setitem(sys.modules, "cv2", None)
    assert list(TD.prefetch(iter(range(5)))) == list(range(5))


TRAIN_MODULES = ("ops.losses", "optim.optimizers", "optim.schedulers",
                 "train.param_groups", "train.trainer", "train.gan",
                 "utils.seeding", "utils.tb", "utils.summary",
                 "utils.profiling", "analysis.visualize", "data.transforms",
                 "data.datasets", "utils.torch_import")
# the experiment drivers and what they call besides inference and training,
# and the host code (synthetic data, dataset builders, offline augmentation)
PIPELINE_MODULES = ("utils.grid", "ops.tiling", "analysis.stat_result",
                    "analysis.stat_result_vessel", "data.patches",
                    "data.synthetic", "data.builders", "data.augment_offline",
                    "pipeline", "pipeline_vessel")
# the zoo families and the ensemble
ZOO_MODULES = ("models.unet", "models.unetplusplus", "models.classic",
               "models.attentionunet", "models.fpn", "models.deeplabv3plus",
               "models.effnet", "models.unet3plus", "models.smp_extra",
               "models.transformers", "models.misc", "infer.ensemble",
               "ensemble")
# multi-GPU: the mesh and its collectives, the H-sharded primitives and
# flagship
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.spatial",
                    "parallel.spatial_model")


def test_port_imports_without_jax_or_image_packages():
    """Every module of the port imports where PIL, matplotlib and cv2 are
    missing, and none pulls in jax, flax, msgpack or the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('PIL', 'matplotlib', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import eyediseasesegmentation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'msgpack', 'eyediseasesegmentation_tpu'))\n"
        "print(' '.join(names))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    listed, last = out.stdout.strip().splitlines()[-2:]
    n, bad = last.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout
    # the train slice's, the drivers', the zoo's and the multi-GPU modules
    # are among those imported
    pkg = "eyediseasesegmentation_tpu_torch."
    assert {pkg + m for m in TRAIN_MODULES + PIPELINE_MODULES
            + ZOO_MODULES + PARALLEL_MODULES} <= set(listed.split()), listed
