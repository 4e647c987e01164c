"""Training engine (torch port).

Counterpart of ``eyediseasesegmentation_tpu/train/trainer.py``: ``Trainer``
with ``train_step``, ``eval_step`` and ``fit``, and the ``train_model`` entry
point. One train step augments on the device (the policy's Python branches,
one sample at a time), runs the forward in the compute dtype (bf16 when
``is_fp16``; parameters stay fp32), the compound loss with deep supervision
on the pooled mask pyramid and the classification loss, the backward and
the optimizer update. The host loop schedules the learning rate
(ReduceLROnPlateau etc.), stops early (patience 20 on val dice), writes
``best.ckpt`` / ``last.ckpt`` / ``best_full.ckpt`` and ``metrics.jsonl`` rows
with the JAX package's keys.

The train forward and backward are plain differentiable ops: the port's
CUDA kernels have no backward, and their wrappers raise when a gradient
would be needed. Validation runs the model in ``eval()`` under
``torch.inference_mode()``, where the kernels run on a card. No autocast
and no loss scale: bf16 needs none, and the JAX step has none.

``remat`` (or ``is_remat``) recomputes activations in the backward instead
of keeping them: per block where the model has the field (the flagship's
encoder blocks and decoder nodes), else over the whole model
(``layers.remat``); the numbers are those without it. ``encoder_weights``
loads a torch ``.pth`` into the encoder after the initialisation
(``utils.torch_import``, JAX's mapping and report), and ``fit(resume_path=)``
resumes from a ``best_full.ckpt`` of either package.

Data parallelism (``parallel.mesh``): the mesh is ``mesh_shape``, else
JAX's rule ``{"data": gcd(batch_size, ranks)}``, and must span the job.
Every rank reads the same host batch and keeps its rows; the forward runs
under ``data_parallel``, so BatchNorm, DropBlock and dropout see the whole
batch; the outputs are gathered (differentiably) and every rank computes
the whole batch's loss and metrics; the gradients are averaged over the
ranks, so every rank takes the step of world size 1. ``eval_step`` splits
its batch the same way and all-reduces its counts. Only rank 0 writes the
run directory; resuming reads the checkpoint on every rank and broadcasts
rank 0's state.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import models as zoo
from ..convert import load_flax, torch_to_flax
from ..data import (OneLesionSegmentation, batch_iterator, get_datapath,
                    get_transform, prefetch, train_val_split)
from ..data.patches import read_img_mask_csv
from ..data.transforms import AugRng
from ..models.modules.layers import remat, set_generator, wide
from ..ops import image as I
from ..ops import losses as L
from ..ops import metrics as M
from ..optim import get_optimizer, get_scheduler, set_learning_rate
from ..parallel import mesh as P
from ..utils import fold_in, make_logdir, set_global_seed
from ..utils.torch_import import import_torch_checkpoint
from .checkpoint import restore_into, resume_state, save_checkpoint
from .param_groups import param_groups

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


def adaptive_avg_pool(mask: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """The deep-supervision mask pyramid (reference get_pyramid,
    train.py:428-445): average pooling of (B, 1, H, W) to each head's
    size."""
    rh, rw = mask.shape[2] // out_hw[0], mask.shape[3] // out_hw[1]
    return F.avg_pool2d(mask, (rh, rw), stride=(rh, rw))


def model_outputs(out):
    """A model output as (final, ds list or None, clf or None)."""
    if not isinstance(out, tuple):
        return out, None, None
    if len(out) == 2 and isinstance(out[1], list):
        return out[0], out[1], None
    if len(out) == 3:
        return out[0], out[1], out[2]
    return out[0], None, out[1]


def _infer_encoder_arch(cfg: Dict[str, Any]) -> str:
    """The torch pretrained architecture of the config's ``encoder_name``
    (BoTSER50_* wraps an se_resnet50 backbone, unetplusplusstar.py:282)."""
    name = str((cfg.get("model_params") or {}).get("encoder_name", ""))
    low = name.lower()
    if "botser50" in low or "seresnet50" in low:
        return "se_resnet50"
    if "seresnext101" in low or low == "unet_seresnext101":
        return "se_resnext101"
    if "swin" in low:
        return "swin_small" if "small" in low else "swin_tiny"
    if "seresnext50" in low:
        return "se_resnext50"
    return "se_resnet50"


@dataclasses.dataclass
class Trainer:
    """Trainer for one experiment config (the JAX ``BaseConfig`` keys). The
    model is built with the flax initializers from ``seed``. ``device``:
    None builds on the GPU and raises without one; pass ``"cpu"`` to train
    on the CPU."""

    configs: Dict[str, Any]
    logdir: Optional[Path] = None
    seed: int = 1999
    device: Any = None

    def __post_init__(self):
        cfg = self.configs
        self.mesh = P.data_mesh(cfg.get("mesh_shape"),
                                int(cfg.get("batch_size", 2)), self.device)
        self.dp = self.mesh.axis_size() > 1
        if self.device is None and self.mesh.size > 1:
            self.device = self.mesh.device
        self.dtype = (torch.bfloat16 if cfg.get("is_fp16", True)
                      else torch.float32)
        # remat: the model's own per-block segments where it has the field
        # (the flagship), else the whole model in one segment (train_step)
        self.remat = bool(cfg.get("remat", cfg.get("is_remat", False)))
        self._model_remat = False
        params = dict(cfg.get("model_params") or {})
        if self.remat:
            try:
                self.model = zoo.get_model(
                    cfg["model_name"], {**params, "remat": True},
                    training=True, dtype=self.dtype, device=self.device)
                self._model_remat = True
            except TypeError:
                params.pop("remat", None)
        if not self._model_remat:
            self.model = zoo.get_model(cfg["model_name"], params,
                                       training=True, dtype=self.dtype,
                                       device=self.device)
        # the flax initializers, from the experiment's seed (the JAX
        # Trainer's init_state)
        zoo.init_flax(self.model,
                      fold_in(torch.Generator().manual_seed(self.seed), 0))
        self.device = next(self.model.parameters()).device
        if cfg.get("encoder_weights"):
            self._import_encoder(cfg)
        if self.mesh.size > 1:
            P.replicate(self.model, self.mesh)
        self.deep_supervision = bool(cfg.get("deep_supervision", False)) or \
            bool(params.get("deep_supervision", False))
        self.scale_size = int(cfg.get("scale_size", 1024))
        self.num_workers = int(cfg.get("num_workers", 4))
        prep_fn, _, _ = zoo.get_preprocessing_fn(
            cfg.get("dataset_name", "IDRiD"), cfg.get("gray", False))
        self.transform = get_transform(cfg.get("augmentation", "advanced"))(
            image_size=self.scale_size, preprocessing_fn=prep_fn)
        self.criterion = dict(cfg.get("criterion") or {"bce": 1.0})
        pos_weights = cfg.get("pos_weights") or [1.0]
        self.loss_fn = L.compound_loss(self.criterion,
                                       pos_weights=pos_weights)
        self.ds_loss_fn = (L.get_loss(cfg.get("criterion_ds") or "bce",
                                      pos_weights=pos_weights)
                           if self.deep_supervision else None)
        self.ds_weight = float(cfg.get("ds_weight", 1.0))
        self.clf_weight = float(cfg.get("clf_weight", 1.0))
        self.metric_name = cfg.get("metric", "dice")
        self.metric_mode = cfg.get("mode", "max")
        # finetune freezes every encoder weight (out of the optimizer, so
        # neither the weights nor their optimizer state move); finetune and
        # a pretrained-encoder import also restore the encoder's BN
        # statistics after each step, while those BNs (not frozen ones)
        # still normalise with batch statistics
        self.finetune = bool(cfg.get("finetune", False))
        self.freeze_bn_scopes = tuple(cfg.get(
            "freeze_bn_scopes",
            ("encoder",) if (self.finetune or cfg.get("encoder_weights"))
            else ()))
        self.frozen_param_scopes = ("encoder",) if self.finetune else ()
        # decoded pixels ship to the device as uint8 and promote there;
        # ``gray`` makes non-integral host floats, which keep fp32
        self._uint8_wire = not bool(cfg.get("gray", False))
        self.optimizer = get_optimizer(
            cfg.get("optimizer", "adamw"),
            param_groups(self.model, cfg["model_name"],
                         float(cfg.get("weight_decay", 1e-5)),
                         self.frozen_param_scopes),
            learning_rate=float(cfg.get("learning_rate", 1e-3)))
        self._frozen_stats = [
            b for name, b in self.model.named_buffers()
            if name.split(".")[0] in self.freeze_bn_scopes
            and name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]
        self.step = 0

    def _import_encoder(self, cfg: Dict[str, Any]) -> None:
        """Load the torch ``.pth`` of ``encoder_weights`` into the encoder
        (``encoder_arch``, else inferred from ``encoder_name``) through the
        JAX layout, with the JAX package's mapping and log line; the
        key-diff report is kept as ``encoder_report``."""
        arch = cfg.get("encoder_arch") or _infer_encoder_arch(cfg)
        variables, report = import_torch_checkpoint(
            cfg["encoder_weights"], torch_to_flax(self.model), arch=arch)
        load_flax(self.model, variables)
        logger.info("pretrained encoder '%s': %d tensors loaded, "
                    "%d missing, %d mismatched", arch,
                    len(report["loaded"]), len(report["missing_in_jax"]),
                    len(report["shape_mismatch"]))
        self.encoder_report = report

    # ------------------------------------------------------------------
    def _wire(self, a: np.ndarray) -> torch.Tensor:
        """A host batch on the device: uint8 when its values are exactly
        integral 0-255 (falls back to fp32 for good otherwise)."""
        if self._uint8_wire and a.dtype != np.uint8:
            u8 = a.astype(np.uint8)
            if (u8 == a).all():
                a = u8
            else:
                self._uint8_wire = False
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def gather(self, out):
        """A model output (tensor, or tuple / list of them) of this rank's
        rows as the whole batch's, on every rank (differentiable); itself
        without data parallelism."""
        if not self.dp or out is None:
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(self.gather(o) for o in out)
        return P.all_gather(out, self.mesh)

    def compute_loss(self, out, m4: torch.Tensor):
        """(total, parts, final) of the model output against the (B, 1, H,
        W) mask: the compound loss on fp32 (or wider) logits, ``ds_weight``
        × the DS loss on each head's pooled mask, and the classification
        loss on ``mask.sum() > 0``."""
        final, ds, clf = model_outputs(out)
        total, parts = self.loss_fn(final.to(wide(final.dtype)), m4)
        if self.deep_supervision and ds is not None:
            for d in ds:
                pyr = adaptive_avg_pool(m4, tuple(d.shape[2:]))
                total = total + self.ds_weight * self.ds_loss_fn(
                    d.to(wide(d.dtype)), pyr)
        if clf is not None:
            label = (m4.sum((1, 2, 3)) > 0).to(clf.dtype)
            clf_loss = L.soft_bce_with_logits(clf.reshape(-1), label)
            parts = {**parts, "clf": clf_loss}
            total = total + self.clf_weight * clf_loss
        return total, parts, final

    def step_generators(self, epoch_gen: torch.Generator):
        """(augmentation draws, dropout generator) of the current step,
        folded from the epoch's generator and the step count."""
        g = fold_in(epoch_gen, self.step)
        return (AugRng(fold_in(g, 0), fold_in(g, 1, self.device)),
                fold_in(g, 2, self.device))

    def train_step(self, images, masks, epoch_gen: torch.Generator,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One step on a host batch (images (B, H, W, 3), masks (B, H, W)):
        augment, forward, loss, backward, update. Returns device scalars."""
        model = self.model
        model.train()
        aug_rng, drop_gen = self.step_generators(epoch_gen)
        rows = P.batch_rows(self.mesh, len(images)) if self.dp else None
        if rows is not None:
            # the samples up to this rank's last are augmented (the draws)
            images, masks = images[:rows.stop], masks[:rows.stop]
        images = self._wire(images).float()
        masks = self._wire(masks).float()
        images, masks = self.transform.batch_train(images, masks, aug_rng,
                                                   rows)
        x = images.permute(0, 3, 1, 2)
        m4 = masks[:, None]
        set_generator(model, drop_gen)
        saved = [b.clone() for b in self._frozen_stats]
        self.optimizer.zero_grad(set_to_none=True)
        with P.data_parallel(self.mesh):
            out = remat(model, x,
                        enabled=self.remat and not self._model_remat)
            out, m4 = self.gather(out), self.gather(m4)
            loss, parts, final = self.compute_loss(out, m4)
            loss.backward()
        P.mean_grads(model.parameters(), self.mesh)
        set_learning_rate(self.optimizer, lr)
        self.optimizer.step()
        with torch.no_grad():
            for b, s in zip(self._frozen_stats, saved):
                b.copy_(s)
            probs = torch.sigmoid(final.float())
            metrics = {"loss": loss.detach(),
                       "dice": M.dice_coeff(probs, m4),
                       "iou": M.iou_coeff(probs, m4)}
            metrics.update({f"loss_{k}": v.detach() for k, v in parts.items()})
        self.step += 1
        return metrics

    def eval_step(self, images, masks, n_valid: int) -> Dict[str, Any]:
        """The eval forward of a host batch (padded to the batch size,
        ``n_valid`` real): the test transform, the GT through
        LongestMaxSize + pad (nearest), val loss and hard counts at 0.5,
        the 19-threshold sweep counts of the valid images, and the raw
        image at eval geometry for the overlays. Under data parallelism
        each rank runs the forward on its rows; the logits are gathered for
        the loss and the overlays, the counts all-reduced. The model is put
        back in ``train()`` mode."""
        model = self.model
        model.eval()
        rows = (P.batch_rows(self.mesh, len(images)) if self.dp
                else slice(None))
        try:
            with torch.inference_mode():
                raw = self._wire(images).float()
                m = self._wire(masks).float()
                m = m[..., None] if m.ndim == 3 else m
                x = self.transform.test(raw[rows]).permute(0, 3, 1, 2)
                out = model(x)
                tm = I.longest_max_size_pad(m, self.scale_size,
                                            method="nearest")
                tm4 = tm.permute(0, 3, 1, 2)
                val_loss, _, final = self.compute_loss(self.gather(out), tm4)
                probs = torch.sigmoid(final.float())
                local = probs[rows]
                first = rows.start or 0
                valid = (torch.arange(first, first + x.shape[0],
                                      device=x.device) < n_valid).float()
                vmask = valid[:, None, None, None]
                pred = (local > 0.5).float() * vmask
                true = (tm4[rows] > 0.5).float() * vmask
                tp, ap, pp, _ = M.threshold_sweep(
                    local, tm4[rows], valid_mask=vmask.expand_as(local))
                counts = torch.cat([torch.stack([(pred * true).sum(),
                                                 pred.sum(), true.sum()]),
                                    tp, ap, pp])
                if self.dp:
                    counts = P.psum(counts, self.mesh)
                k = len(tp)
                vis = I.longest_max_size_pad(raw, self.scale_size)
                return {"inter": counts[0], "pred": counts[1],
                        "true": counts[2], "tp": counts[3:3 + k],
                        "ap": counts[3 + k:3 + 2 * k],
                        "pp": counts[3 + 2 * k:], "loss": val_loss,
                        "vis_img": vis, "probs": probs[:, 0],
                        "gt": tm[..., 0]}
        finally:
            model.train()

    # ------------------------------------------------------------------
    def _checkpoints(self, logdir: Path, metric: float, epoch: int,
                     best: bool) -> None:
        weights = {"model_state_dict": torch_to_flax(self.model),
                   "metric": float(metric), "epoch": epoch}
        if best:
            save_checkpoint(logdir / "checkpoints" / "best.ckpt", weights)
        save_checkpoint(logdir / "checkpoints" / "last.ckpt", weights)
        save_checkpoint(logdir / "checkpoints" / "best_full.ckpt",
                        resume_state(self.model, self.optimizer, self.step,
                                     epoch))

    def fit(self, train_ds, valid_ds, num_epochs: Optional[int] = None,
            resume_path: Optional[str] = None) -> Dict[str, Any]:
        cfg = self.configs
        num_epochs = num_epochs or int(cfg.get("num_epochs", 100))
        batch_size = int(cfg.get("batch_size", 2))
        patience = int(cfg.get("early_stopping_patience", 20))
        logdir = Path(self.logdir) if self.logdir else Path("models/_scratch")
        main = self.mesh.is_main
        if main:
            (logdir / "checkpoints").mkdir(parents=True, exist_ok=True)

        root = set_global_seed(self.seed)
        start_epoch = 0
        if resume_path:
            restored = restore_into(self.model, self.optimizer, resume_path)
            if self.mesh.size > 1:
                P.replicate(self.model, self.mesh)
                P.broadcast_([t for st in self.optimizer.state.values()
                              for t in st.values()
                              if isinstance(t, torch.Tensor)], self.mesh)
            self.step = restored["step"]
            start_epoch = restored["epoch"] + 1
            logger.info("resumed from %s at epoch %d", resume_path,
                        start_epoch)

        n_train_batches = max(1, len(train_ds) // batch_size)
        lr = float(cfg.get("learning_rate", 1e-3))
        scheduler = get_scheduler(cfg.get("scheduler", "reduce"), lr,
                                  num_epochs, n_train_batches,
                                  mode=self.metric_mode)
        best_metric = -np.inf if self.metric_mode == "max" else np.inf
        bad_epochs = 0
        history = []
        global_step = 0
        metrics_file = logdir / "metrics.jsonl"
        from ..utils.tb import TensorBoardWriter, row_to_scalars
        tb = TensorBoardWriter(
            logdir, enabled=main and bool(cfg.get("tensorboard", True)))
        visualize = main and bool(cfg.get("visualize_batches", True))

        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            # ---- train ----
            epoch_gen = fold_in(root, 1000 + epoch)
            train_metrics = []
            for batch in prefetch(batch_iterator(
                    train_ds, batch_size, shuffle=True, drop_last=True,
                    seed=self.seed + epoch, workers=self.num_workers)):
                if scheduler is not None and scheduler.batch_update:
                    lr = scheduler.batch_lr(global_step)
                train_metrics.append(self.train_step(
                    batch["image"], batch["mask"], epoch_gen, lr))
                global_step += 1
            train_agg = ({k: float(torch.stack([m[k] for m in train_metrics])
                                   .float().mean())
                          for k in train_metrics[0]} if train_metrics else {})

            # ---- validate ----
            # val dice / iou are per-batch means (the reference's Catalyst
            # callbacks); the global-count variants ride along
            eps = 1e-7
            inter = pred = true = 0.0
            tp = np.zeros(len(M.THRESH_LIST))
            ap, pp = np.zeros_like(tp), np.zeros_like(tp)
            vlosses, batch_dices, batch_ious = [], [], []
            best_b = worst_b = None

            def consume(entry):
                nonlocal inter, pred, true, best_b, worst_b, tp, ap, pp
                r, nv = entry
                bi, bp, bt = (float(r["inter"]), float(r["pred"]),
                              float(r["true"]))
                inter += bi
                pred += bp
                true += bt
                vlosses.append(float(r["loss"]))
                tp += r["tp"].cpu().numpy()
                ap += r["ap"].cpu().numpy()
                pp += r["pp"].cpu().numpy()
                bd = (2 * bi + eps) / (bp + bt + eps)
                batch_dices.append(bd)
                batch_ious.append((bi + eps) / (bp + bt - bi + eps))
                if visualize:
                    if best_b is None or bd > best_b[0]:
                        best_b = (bd, r["vis_img"], r["gt"], r["probs"], nv)
                    if worst_b is None or bd < worst_b[0]:
                        worst_b = (bd, r["vis_img"], r["gt"], r["probs"], nv)

            # the host reads a batch's scalars one batch behind the device
            pending: deque = deque()
            for batch in prefetch(batch_iterator(
                    valid_ds, batch_size, shuffle=False,
                    workers=self.num_workers)):
                pending.append((self.eval_step(batch["image"], batch["mask"],
                                               int(batch["n_valid"])),
                                int(batch["n_valid"])))
                if len(pending) > 1:
                    consume(pending.popleft())
            while pending:
                consume(pending.popleft())
            val_dice = float(np.mean(batch_dices)) if batch_dices else 0.0
            val_iou = float(np.mean(batch_ious)) if batch_ious else 0.0
            sn = (tp + eps) / (ap + eps)
            ppv = (tp + eps) / (pp + eps)
            val_metrics = {
                "dice": val_dice, "iou": val_iou,
                "dice_global": (2 * inter + eps) / (pred + true + eps),
                "iou_global": (inter + eps) / (pred + true - inter + eps),
                "aucpr": float(np.trapezoid(ppv[::-1], sn[::-1])),
                "loss": float(np.mean(vlosses)) if vlosses else 0.0}

            if visualize and best_b is not None:
                self._save_overlays(logdir / "visuals", epoch,
                                    (("best", best_b), ("worst", worst_b)))

            # ---- schedule / select / stop ----
            metric_val = val_metrics.get(self.metric_name, val_dice)
            if scheduler is not None and not scheduler.batch_update:
                lr = scheduler.epoch_lr(epoch, metric_val)
            better = (metric_val > best_metric if self.metric_mode == "max"
                      else metric_val < best_metric)
            if better:
                best_metric = metric_val
                bad_epochs = 0
            else:
                bad_epochs += 1
            if main:
                self._checkpoints(logdir, metric_val, epoch, better)

            row = {"epoch": epoch, "lr": lr, "time": time.time() - t0,
                   **{f"train_{k}": v for k, v in train_agg.items()},
                   **{f"val_{k}": v for k, v in val_metrics.items()}}
            history.append(row)
            if main:
                with open(metrics_file, "a") as f:
                    f.write(json.dumps(row) + "\n")
            tb.add_scalars(epoch, row_to_scalars(row))
            logger.info("epoch %d | loss %.4f | val_dice %.4f | lr %.2e | "
                        "%.1fs", epoch, train_agg.get("loss", float("nan")),
                        val_dice, lr, row["time"])
            if bad_epochs >= patience:
                logger.info("early stopping at epoch %d (patience %d)",
                            epoch, patience)
                break

        tb.close()
        return {"history": history, "best_metric": float(best_metric),
                "logdir": logdir}

    @staticmethod
    def _save_overlays(vis_dir: Path, epoch: int, picks) -> None:
        """The best and worst val batches as GT-vs-prediction strips (the
        reference's ShowPolarBatchesCallback, train.py:323-327)."""
        from PIL import Image

        from ..analysis.visualize import overlay_mask_image

        vis_dir.mkdir(parents=True, exist_ok=True)
        for tag, (d, im, gt, pr, nv) in picks:
            im, gt, pr = (t[:nv].float().cpu().numpy() for t in (im, gt, pr))
            panels = [overlay_mask_image(im[i], gt[i] > 0.5, pr[i] > 0.5)
                      for i in range(im.shape[0])]
            if panels:
                Image.fromarray(np.concatenate(panels, axis=1)).save(
                    vis_dir / f"epoch{epoch:03d}_{tag}_dice{d:.3f}.png")


def train_model(exp_name: str, configs: Dict[str, Any], seed: int = 1999,
                models_root: str = "models", device=None) -> Path:
    """The reference entry point (train.py:160): build the datasets from the
    config's paths (``data_type: "tile"``: from the patch csvs
    ``tile_train_csv`` / ``tile_val_csv``, by default under
    ``processed_root``), train, and write checkpoints and config.json under
    ``<models_root>/<dataset>/<lesion>/<exp_name>/``. Under ``torchrun``
    every rank trains its share of each batch and rank 0 alone writes."""
    cfg = dict(configs)
    ds_name, lesion = cfg.get("dataset_name", "IDRiD"), cfg.get(
        "lesion_type", "EX")
    if P.is_main_process():
        logdir = make_logdir(models_root, ds_name, lesion, exp_name)
        with open(logdir / "config.json", "w") as f:
            json.dump(cfg, f, indent=2, default=str)
    else:
        logdir = Path(models_root) / ds_name / lesion / str(exp_name)
    if cfg.get("data_type", "all") == "tile":
        # the img_mask.csv patch lists of data.patches.build_dataframe
        # (reference train.py:77-110 reads
        # data/processed/<ds>/{train,val}/<lesion>/img_mask.csv)
        root = Path(cfg.get("processed_root", "data/processed"))
        base = root / cfg.get("dataset_name", "IDRiD")
        lesion = cfg.get("lesion_type", "EX")
        tr_i, tr_m = read_img_mask_csv(
            cfg.get("tile_train_csv")
            or base / "train" / lesion / "img_mask.csv")
        va_i, va_m = read_img_mask_csv(
            cfg.get("tile_val_csv") or base / "val" / lesion / "img_mask.csv")
    else:
        imgs, masks = get_datapath(Path(cfg["train_img_path"]),
                                   Path(cfg["train_mask_path"]),
                                   cfg.get("lesion_type", "EX"))
        (tr_i, tr_m), (va_i, va_m) = train_val_split(
            imgs, masks, val_size=float(cfg.get("val_size", 0.2)), seed=seed)
    kw = dict(gray=cfg.get("gray", False),
              ben_transform=cfg.get("use_ben_transform", False))
    train_ds = OneLesionSegmentation(tr_i, tr_m, **kw)
    valid_ds = OneLesionSegmentation(va_i, va_m, **kw)
    logger.info("train %d | valid %d images", len(train_ds), len(valid_ds))
    trainer = Trainer(cfg, logdir=logdir, seed=seed, device=device)
    result = trainer.fit(train_ds, valid_ds,
                         resume_path=cfg.get("resume_path"))
    logger.info("best %s: %.4f", cfg.get("metric", "dice"),
                result["best_metric"])
    return logdir
