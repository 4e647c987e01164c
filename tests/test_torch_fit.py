"""The port's ``fit`` / ``train_model`` on a tiny synthetic tree, against the
JAX package's artifact contract.

One module-scoped run: ``classic_unet`` (filters 8-16, a few hundred KB of
checkpoints; the flagship's own train step is held in
test_torch_train_step.py) trained by the port for 2 epochs at 64²
(``advanced`` augmentation, fp32, on the CPU) on the JAX package's
synthetic IDRiD tree (6 images of 48×64: 5 train, 1 val), deleted with the
module's last test.
It must write the JAX layout (``config.json``, ``metrics.jsonl`` rows with
the JAX trainer's keys, ``best`` / ``last`` / ``best_full`` checkpoints,
the overlay strips); both packages' ``test_tta`` evaluate the run (the JAX
one reads the port's ``best.ckpt`` with its own ``load_checkpoint`` and
runs its model on it): ``mean_auc`` within 1e-4. Resuming from
``best_full.ckpt`` restores the weights, the optimizer state and the step
count and trains on from the next epoch. ``train_val_split`` is the JAX
package's, exactly.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu.data.datasets import (
    train_val_split as jtrain_val_split)
from eyediseasesegmentation_tpu.data.synthetic import make_idrid_tree
from eyediseasesegmentation_tpu.infer.tta import test_tta as jtest_tta
from eyediseasesegmentation_tpu.train.checkpoint import (
    load_checkpoint as jload_checkpoint)
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.data.datasets import train_val_split
from eyediseasesegmentation_tpu_torch.infer.tta import test_tta
from eyediseasesegmentation_tpu_torch.train.checkpoint import (
    load_checkpoint, restore_into)
from eyediseasesegmentation_tpu_torch.train.trainer import (Trainer,
                                                            train_model)

EPOCHS = 2
# the keys of a JAX metrics.jsonl row for this criterion (trainer.py:566-568)
ROW_KEYS = {"epoch", "lr", "time", "train_loss", "train_dice", "train_iou",
            "train_loss_bce", "train_loss_log_dice", "val_dice", "val_iou",
            "val_dice_global", "val_iou_global", "val_aucpr", "val_loss"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    yield _train(root)
    shutil.rmtree(root)


def _train(root):
    make_idrid_tree(root / "data", lesion_type="EX", n_train=6, n_test=2,
                    size=(48, 64))
    cfg = {"train_img_path": str(root / "data" / "train" / "image"),
           "train_mask_path": str(root / "data" / "train" / "mask"),
           "lesion_type": "EX", "dataset_name": "IDRiD", "scale_size": 64,
           "num_epochs": EPOCHS, "batch_size": 2, "is_fp16": False,
           "augmentation": "advanced", "num_workers": 0,
           "model_name": "classic_unet",
           "model_params": {"filters": [8, 16], "classes": 1},
           "criterion": {"bce": 0.8, "log_dice": 0.2}, "pos_weights": [5.0],
           # both test_tta then evaluate in fp32 (their default is bf16)
           "inference_dtype": "float32"}
    logdir = train_model("port", cfg, seed=1999,
                         models_root=str(root / "models"), device="cpu")
    return {"root": root, "cfg": cfg, "logdir": logdir}


@pytest.mark.parametrize("n", [1, 2, 5, 6, 13])
def test_train_val_split_matches_jax(n):
    a, b = [f"i{k}" for k in range(n)], [f"m{k}" for k in range(n)]
    for seed in (0, 1999):
        assert train_val_split(a, b, 0.2, seed) == \
            jtrain_val_split(a, b, 0.2, seed)


def test_train_model_writes_the_jax_layout(run):
    logdir = run["logdir"]
    assert logdir == run["root"] / "models" / "IDRiD" / "EX" / "port"
    assert json.loads((logdir / "config.json").read_text()) == run["cfg"]
    rows = [json.loads(line) for line in
            (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == list(range(EPOCHS))
    for r in rows:
        assert set(r) == ROW_KEYS
        assert all(np.isfinite(v) for v in r.values())
        assert 0.0 <= r["val_dice"] <= 1.0 and 0.0 <= r["val_aucpr"] <= 1.0
    for name in ("best", "last", "best_full"):
        assert (logdir / "checkpoints" / f"{name}.ckpt").is_file()
    best = load_checkpoint(logdir / "checkpoints" / "best.ckpt")
    assert set(best) == {"model_state_dict", "metric", "epoch"}
    assert set(best["model_state_dict"]) == {"params", "batch_stats"}
    assert len(list((logdir / "visuals").glob("epoch*_best_*.png"))) == \
        EPOCHS


def test_both_test_tta_evaluate_the_port_run(run, tmp_path):
    make_idrid_tree(tmp_path / "data", lesion_type="EX", n_train=0,
                    n_test=3, size=(48, 64))
    test = {"test_img_path": str(tmp_path / "data" / "test" / "image"),
            "test_mask_path": str(tmp_path / "data" / "test" / "label")}
    args = {"tta": "d4", "createprob": "false"}
    got = test_tta(run["logdir"], {**test, "out_dir": str(tmp_path / "t")},
                   args, batch_size=2, device="cpu")
    want = jtest_tta(run["logdir"], {**test, "out_dir": str(tmp_path / "j")},
                     args, batch_size=2)
    assert np.isfinite(got["mean_auc"])
    assert abs(got["mean_auc"] - want["mean_auc"]) <= 1e-4
    # the JAX reader sees the port's weights, leaf for leaf
    jbest = jload_checkpoint(run["logdir"] / "checkpoints" / "best.ckpt")
    tbest = load_checkpoint(run["logdir"] / "checkpoints" / "best.ckpt")
    assert int(jbest["epoch"]) == int(tbest["epoch"])
    for coll in ("params", "batch_stats"):
        jl = jbest["model_state_dict"][coll]
        tl = tbest["model_state_dict"][coll]
        assert sorted(jl) == sorted(tl)


def test_resume_from_best_full_continues(run, tmp_path):
    logdir = tmp_path / "port"
    shutil.copytree(run["logdir"], logdir)
    full = load_checkpoint(logdir / "checkpoints" / "best_full.ckpt")
    trainer = Trainer(run["cfg"], logdir=logdir, seed=1999, device="cpu")
    restored = restore_into(trainer.model, trainer.optimizer,
                            logdir / "checkpoints" / "best_full.ckpt")
    # 5 train images, batch 2, drop_last: 2 steps an epoch
    assert restored == {"step": 2 * EPOCHS, "epoch": EPOCHS - 1}
    last = load_checkpoint(logdir / "checkpoints" / "last.ckpt")
    weights = torch_to_flax(trainer.model)
    for coll in ("params", "batch_stats"):
        for path, want in _leaves(last["model_state_dict"][coll]):
            np.testing.assert_array_equal(_get(weights[coll], path), want)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    assert len(trainer.optimizer.state) == len(full["optimizer"]) > 0
    for p, state in trainer.optimizer.state.items():
        saved = full["optimizer"][names[id(p)]]
        for k, v in state.items():
            np.testing.assert_array_equal(v.cpu().numpy(), saved[k])

    trainer = Trainer({**run["cfg"], "num_epochs": EPOCHS + 1},
                      logdir=logdir, seed=1999, device="cpu")
    trainer.fit(*_datasets(run), resume_path=str(
        logdir / "checkpoints" / "best_full.ckpt"))
    assert trainer.step == 2 * (EPOCHS + 1)
    rows = [json.loads(line) for line in
            (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == list(range(EPOCHS + 1))
    after = load_checkpoint(logdir / "checkpoints" / "best_full.ckpt")
    assert int(after["step"]) == 2 * (EPOCHS + 1)


def _datasets(run):
    from eyediseasesegmentation_tpu_torch.data import (OneLesionSegmentation,
                                                       get_datapath)
    cfg = run["cfg"]
    imgs, masks = get_datapath(cfg["train_img_path"], cfg["train_mask_path"],
                               "EX")
    (ti, tm), (vi, vm) = train_val_split(imgs, masks, 0.2, 1999)
    return OneLesionSegmentation(ti, tm), OneLesionSegmentation(vi, vm)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("extra", [{"mesh_shape": {"data": 2}}])
def test_trainer_refuses_what_is_not_ported(extra):
    cfg = {"model_name": "unetplusplusstar", "model_params": {"base_dim": 2},
           **extra}
    # data parallelism is ported: two data ranks on a one-rank job raise
    # (tests/test_torch_data_parallel.py trains on two)
    with pytest.raises(ValueError, match="covers 2 ranks, but the job has 1"):
        Trainer(cfg, device="cpu")


def test_train_model_refuses_tile_data(tmp_path):
    """Tile mode reads the patch lists of ``build_dataframe``; without one
    it stops before building a model."""
    with pytest.raises(FileNotFoundError, match="img_mask.csv"):
        train_model("tile", {"data_type": "tile",
                             "processed_root": str(tmp_path / "none")},
                    models_root=str(tmp_path), device="cpu")
