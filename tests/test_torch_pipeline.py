"""Port parity: the experiment drivers and what they call besides inference
(the result CSVs, patch extraction and tile-mode training's lists) against
the JAX package, and the port's ``pipeline`` / ``pipeline_vessel``
``start_experiment`` end to end on the CPU.

``export_result`` / ``export_result_vessel`` and ``build_patches`` /
``build_dataframe`` / ``read_img_mask_csv`` run in both packages on the
same files: byte-identical CSVs, the same patch files and pixels. Tile-mode
``train_model`` is held to the JAX one's train and val lists (each
package's ``Trainer`` replaced by a stub that records the datasets, so no
JAX train step is compiled). The drivers run the port alone (1 epoch,
``classic_unet`` at filters 8-16 at 64², fp32 training, ``hflip`` TTA; the
run's subject is the tree, and its checkpoints take a few hundred KB where
the flagship's took 1.2 GB) on the JAX package's synthetic trees and must
write the tree the root drivers write.
The trainer's TensorBoard sink is switched off here: it is a log, not part
of that tree, and importing its writer costs more than the run.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from eyediseasesegmentation_tpu.analysis import stat_result as jstat
from eyediseasesegmentation_tpu.data import patches as jpatches
from eyediseasesegmentation_tpu.data.synthetic import (make_idrid_tree,
                                                       make_vessel_tree)
from eyediseasesegmentation_tpu.train import trainer as jtrainer
from eyediseasesegmentation_tpu_torch import pipeline, pipeline_vessel
from eyediseasesegmentation_tpu_torch.analysis import stat_result as tstat
from eyediseasesegmentation_tpu_torch.analysis.stat_result_vessel import (
    export_result_vessel)
from eyediseasesegmentation_tpu_torch.data import patches as tpatches
from eyediseasesegmentation_tpu_torch.data.paths import lesion_dict
from eyediseasesegmentation_tpu_torch.train import trainer as ttrainer
from eyediseasesegmentation_tpu_torch.utils import tb

CSVS = ("sn", "ppv", "sp", "iou", "dice")
MODEL = {"model_name": "classic_unet",
         "model_params": {"filters": [8, 16], "classes": 1}}


def _write_masks(d, names, masks):
    d.mkdir(parents=True, exist_ok=True)
    for name, m in zip(names, masks):
        Image.fromarray((m * 255).astype(np.uint8)).save(d / name)


@pytest.mark.parametrize("layout", ["IDRiD", "vessel"])
def test_export_result_matches_jax(layout, tmp_path):
    """Per-image rows, the empty-set conventions (an image with empty GT
    and prediction, one with empty GT only), a missing prediction skipped,
    and the ``Avg:`` row: the five CSVs byte for byte."""
    rng = np.random.RandomState(0)
    masks = [(rng.rand(24, 32) < 0.2).astype(np.uint8) for _ in range(4)]
    masks[1][:] = 0
    masks[2][:] = 0
    preds = [m.copy() for m in masks]
    preds[0] = (rng.rand(24, 32) < 0.3).astype(np.uint8)
    preds[2][3:6, 4:9] = 1
    if layout == "IDRiD":
        cfg = {"dataset_name": "IDRiD", "lesion_type": "EX"}
        gt_names = [f"IDRiD_0{i}_EX.tif" for i in range(4)]
        pred_names = [f"IDRiD_0{i}.jpg" for i in range(4)]
        sub = lesion_dict["EX"].dir_name
    else:
        cfg = {"dataset_name": "DRIVE", "lesion_type": "Vessel_DRIVE"}
        gt_names = pred_names = [f"{i}.jpg" for i in range(4)]
        sub = ""
    _write_masks(tmp_path / "gt" / sub, gt_names, masks)
    out = {}
    for name, fn in (("jax", jstat.export_result),
                     ("port", tstat.export_result if layout == "IDRiD"
                      else export_result_vessel)):
        test = dict(cfg, test_mask_path=str(tmp_path / "gt"),
                    out_dir=str(tmp_path / name))
        _write_masks(tmp_path / name / cfg["dataset_name"] / "tta" / "x"
                     / "exp", pred_names[:3], preds[:3])
        out[name] = fn("x/exp", test)
    assert out["port"] == tmp_path / "port" / cfg["dataset_name"] / \
        "result_assessment" / "x" / "exp"
    for key in CSVS:
        got = (out["port"] / f"{key}.csv").read_bytes()
        assert got == (out["jax"] / f"{key}.csv").read_bytes(), key
        lines = got.decode().splitlines()
        assert len(lines) == 4 and lines[-1].startswith("Avg:,")


def test_patches_and_csv_match_jax(tmp_path, monkeypatch):
    """The same patch files and pixels, the same rebalancing, and a
    byte-identical ``img_mask.csv`` (a comma in a directory name, so the
    minimal quoting shows); the csv read back to the same lists."""
    make_idrid_tree(tmp_path / "data", lesion_type="EX", n_train=2,
                    n_test=0, size=(96, 136))
    img_dir = tmp_path / "data" / "train" / "image"
    msk_dir = tmp_path / "data" / "train" / "mask" / lesion_dict[
        "EX"].dir_name
    imgs, masks = sorted(img_dir.iterdir()), sorted(msk_dir.iterdir())
    # an image without lesions: more negatives than positives to remove
    Image.fromarray(np.zeros((96, 136), np.uint8)).save(masks[1])
    counts = {}
    for name, mod in (("jax", jpatches), ("port", tpatches)):
        counts[name] = mod.build_patches(
            imgs, masks, tmp_path / name / "a,b" / "image",
            tmp_path / name / "a,b" / "mask", window=48, min_overlap=16)
    assert counts["port"] == counts["jax"] and counts["port"]["removed"] > 0
    for sub in ("image", "mask"):
        want = sorted(os.listdir(tmp_path / "jax" / "a,b" / sub))
        assert sorted(os.listdir(tmp_path / "port" / "a,b" / sub)) == want
        for f in want:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port" / "a,b" / sub / f)),
                np.asarray(Image.open(tmp_path / "jax" / "a,b" / sub / f)))
    base = tmp_path / "jax" / "a,b"
    want_csv = jpatches.build_dataframe(base / "image", base / "mask",
                                        tmp_path / "jax.csv")
    got_csv = tpatches.build_dataframe(base / "image", base / "mask",
                                       tmp_path / "port.csv")
    assert got_csv.read_bytes() == want_csv.read_bytes()
    assert b'"' in got_csv.read_bytes()
    assert tpatches.read_img_mask_csv(got_csv) == \
        jpatches.read_img_mask_csv(want_csv)
    # relative paths, rebased on a root
    monkeypatch.chdir(tmp_path)
    rel = tpatches.build_dataframe(Path("jax/a,b/image"),
                                   Path("jax/a,b/mask"), Path("rel.csv"))
    assert tpatches.read_img_mask_csv(rel, root=Path("/r")) == \
        jpatches.read_img_mask_csv(rel, root=Path("/r"))


class _Recorder:
    """Stands in for a package's ``Trainer``: records the datasets
    ``train_model`` hands to ``fit``."""

    seen = []

    def __init__(self, cfg, logdir=None, seed=0, device=None):
        pass

    def fit(self, train_ds, valid_ds, resume_path=None):
        self.seen.append([[Path(p) for p in getattr(ds, k)]
                          for ds in (train_ds, valid_ds)
                          for k in ("image_paths", "mask_paths")])
        return {"best_metric": 0.0}


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["tile_csvs", "processed_root"])
def test_tile_train_model_reads_the_jax_lists(explicit, tmp_path,
                                              monkeypatch):
    lists = {}
    for split, n in (("train", 3), ("val", 2)):
        d = tmp_path / "proc" / "IDRiD" / split / "EX"
        for sub in ("image", "mask"):
            (d / sub).mkdir(parents=True)
            for i in range(n):
                (d / sub / f"p{i}.jpg").write_bytes(b"")
        lists[split] = tpatches.build_dataframe(d / "image", d / "mask")
    cfg = {"data_type": "tile", "dataset_name": "IDRiD", "lesion_type": "EX"}
    if explicit:
        cfg.update(tile_train_csv=str(lists["train"]),
                   tile_val_csv=str(lists["val"]))
    else:
        cfg.update(processed_root=str(tmp_path / "proc"))
    _Recorder.seen = []
    monkeypatch.setattr(jtrainer, "Trainer", _Recorder)
    monkeypatch.setattr(ttrainer, "Trainer", _Recorder)
    jtrainer.train_model("j", cfg, models_root=str(tmp_path / "m"))
    ttrainer.train_model("t", cfg, models_root=str(tmp_path / "m"),
                         device="cpu")
    want, got = _Recorder.seen
    assert got == want and [len(x) for x in got] == [3, 3, 2, 2]


@pytest.fixture
def quiet_trainer(monkeypatch):
    writer = tb.TensorBoardWriter
    monkeypatch.setattr(tb, "TensorBoardWriter",
                        lambda logdir, enabled=True: writer(logdir, False))


def _lesion_tree(root, tile):
    """The IDRiD layout for ``data_type`` all, or its patch lists under
    data/processed for tile."""
    make_idrid_tree(root / "data", lesion_type="EX", n_train=3, n_test=2,
                    size=(96, 128) if tile else (48, 64))
    cfg = {"lesion_type": "EX",
           "test_img_path": "data/test/image",
           "test_mask_path": "data/test/label"}
    if not tile:
        return dict(cfg, train_img_path="data/train/image",
                    train_mask_path="data/train/mask")
    imgs = sorted((root / "data" / "train" / "image").iterdir())
    masks = sorted((root / "data" / "train" / "mask"
                    / lesion_dict["EX"].dir_name).iterdir())
    for split, sl in (("train", slice(0, 1)), ("val", slice(1, 2))):
        d = Path("data/processed/IDRiD") / split / "EX"
        tpatches.build_patches(imgs[sl], masks[sl], d / "image",
                               d / "mask", window=64, min_overlap=0)
        tpatches.build_dataframe(d / "image", d / "mask")
    return dict(cfg, data_type="tile")


@pytest.fixture
def run_root(tmp_path, monkeypatch):
    """The working directory of a driver run; its checkpoints are deleted
    afterwards."""
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    shutil.rmtree(tmp_path / "models", ignore_errors=True)


@pytest.mark.parametrize("kind", ["lesion_all", "lesion_tile", "vessel"])
def test_driver_writes_the_root_tree(kind, run_root, quiet_trainer):
    tmp_path = run_root
    if kind == "vessel":
        make_vessel_tree(tmp_path / "vdata", n_train=3, n_test=2,
                         size=(64, 64))
        cfg = {"train_img_path": "vdata/train/image",
               "train_mask_path": "vdata/train/mask",
               "test_img_path": "vdata/test/image",
               "test_mask_path": "vdata/test/mask"}
        driver, ds, lesion = pipeline_vessel, "DRIVE", "Vessel_DRIVE"
    else:
        cfg = _lesion_tree(tmp_path, kind == "lesion_tile")
        driver, ds, lesion = pipeline, "IDRiD", "EX"
    cfg.update(scale_size=64, num_epochs=1, batch_size=2, is_fp16=False,
               pos_weights=[5.0], **MODEL)
    Path("override.json").write_text(json.dumps(cfg))
    logdir, result = driver.start_experiment(pipeline.parse_arg(
        ["--config", "override.json", "--exp_name", "e1", "--tta", "hflip",
         "--device", "cpu"]))

    assert logdir == Path("models") / ds / lesion / "e1"
    saved = json.loads((logdir / "config.json").read_text())
    assert saved["augmentation"] == ("advanced_vessel" if kind == "vessel"
                                     else "advanced")
    rows = (logdir / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])["epoch"] == 0
    for name in ("best", "last", "best_full"):
        assert (logdir / "checkpoints" / f"{name}.ckpt").is_file()
    assert np.isfinite(result["mean_auc"])
    out = Path("outputs") / ds
    names = {"lesion_all": ["IDRiD_te00.jpg", "IDRiD_te01.jpg"],
             "lesion_tile": ["IDRiD_te00.jpg", "IDRiD_te01.jpg"],
             "vessel": ["0.jpg", "1.jpg"]}[kind]
    assert result["out_dir"] == str(out / "tta" / lesion / "e1")
    assert sorted(os.listdir(out / "tta" / lesion / "e1")) == names
    prob = out / "tta" / lesion / "prob_image" / "e1"
    # createprob is forced on the lesion driver; tiled export writes none
    assert prob.is_dir() == (kind == "lesion_all")
    if kind == "lesion_all":
        assert sorted(os.listdir(prob)) == names
    figure = "e1_roc.jpg" if kind == "vessel" else "e1.jpg"
    assert (out / "figures" / lesion / figure).is_file()
    for key in CSVS:
        lines = (out / "result_assessment" / lesion / "e1"
                 / f"{key}.csv").read_text().splitlines()
        assert len(lines) == 3 and lines[-1].startswith("Avg:,")
        vals = [float(x.split(",")[1]) for x in lines]
        assert all(0.0 <= v <= 1.0 for v in vals), (key, vals)


def test_parse_arg_defaults():
    args = pipeline.parse_arg([])
    assert args == {"createprob": "false", "optim_thres": 0.0,
                    "best": "true", "tta": "d4", "config": None,
                    "exp_name": None, "device": None}
    assert pipeline.SEED == 1999
    assert pipeline_vessel.VESSEL_DEFAULTS["scale_size"] == 608
