"""Adversarial fine-tuning (torch port).

Counterpart of ``eyediseasesegmentation_tpu/train/gan.py`` (reference
``src/main/train_gan.py``). A patch discriminator (:class:`DNet`) scores
(image ⊗ mask) patches. Per batch the discriminator trains on real =
image·mask against fake = image·sigmoid(G(x)) patch grids
(:func:`image_to_patch`) with D-loss = mean(1 − D(real)) + mean(D(fake));
then the generator trains on its segmentation loss plus
mean(1 − D(fake))·``d_weight`` against the updated discriminator. Every
``eval_every`` epochs (and at the last) the mean per-image average precision
picks ``best_gan.ckpt``, which holds the JAX package's tree
(``{epoch, step, g_state_dict, g_batch_stats, d_state_dict}`` in flax
naming), so either package reads the other's.

The step is the JAX step's, in two passes: the D step runs G in eval mode
on G's current weights without a gradient (no BatchNorm update); the G
step runs G in train mode (its BatchNorm statistics move) and D with its
parameters frozen, so that D collects no gradient from G's backward. The
generator is fp32 whatever ``is_fp16`` says, and its train forward launches
no CUDA kernel of the port (they have no backward). Both optimizers are the
registry's ``adam`` with the JAX defaults: weight decay 1e-5 coupled into
every parameter's gradient (no mask, no lr groups) and eps 1e-5.

As in the JAX trainer, every ``fit`` starts from the beginning: it draws
G and D again from ``seed`` (the flax initializers, ``models.init_flax``,
on the same ``fold_in`` streams), resets both Adam states and the step
count, so two ``fit`` calls on one trainer give the same history and the
same ``best_gan.ckpt``. The trainer also draws them when it is built, so
``train_step`` works before any ``fit``, and
:meth:`GanTrainer.load_checkpoint` loads a ``best_gan.ckpt`` of either
package for ``evaluate_ap`` / ``predict_probs``.

Data parallelism follows the trainer's rules (``train/trainer.py``): the
mesh is ``mesh_shape``, else ``{"data": gcd(batch_size, ranks)}``; each
rank takes its rows of D's and G's batch, the patch scores and G's logits
are gathered (differentiably) so that both losses are the whole batch's,
G's BatchNorms run under ``data_parallel``, both models' gradients are
averaged over the ranks, ``evaluate_ap`` all-reduces its sums, and rank 0
alone writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import models as zoo
from ..convert import gan_to_flax, load_gan
from ..data.datasets import batch_iterator
from ..models.modules.layers import (PortModule, conv2d_same, linear,
                                     set_generator, wide)
from ..ops import losses as L
from ..ops import metrics as M
from ..optim import get_optimizer
from ..parallel import mesh as P
from ..utils import fold_in
from .checkpoint import load_checkpoint, save_checkpoint

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")

GAN_WEIGHT_DECAY = 1e-5     # the JAX registry's default, on every leaf


class DNet(PortModule):
    """Patch discriminator: four 4×4 stride-2 convs of ``base``·(1, 2, 4, 8)
    channels with flax's SAME padding, each followed by leaky-ReLU 0.2, a
    spatial mean, ``Dense_0`` to one score and a sigmoid in fp32
    (reference train_gan.py:48-91). NCHW RGB in, (n, 1) out."""

    def __init__(self, base: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, base * mult, 4))
            cin = base * mult
        self.Dense_0 = nn.Linear(cin, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(4):
            y = F.leaky_relu(conv2d_same(y, getattr(self, f"conv{i}"),
                                         self.dtype, stride=2), 0.2)
        y = linear(y.mean(dim=(2, 3)), self.Dense_0, self.dtype)
        return torch.sigmoid(y.to(wide(self.dtype)))


def image_to_patch(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) → (B·g_h·g_w, C, patch, patch): the image cropped to
    whole patches and cut row-major over the grid (l.153-157)."""
    n, c, h, w = x.shape
    gh, gw = h // patch, w // patch
    x = x[:, :, :gh * patch, :gw * patch]
    x = x.reshape(n, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n * gh * gw, c, patch, patch)


def _logits(out) -> torch.Tensor:
    return out[0] if isinstance(out, (tuple, list)) else out


@dataclasses.dataclass
class GanTrainer:
    """G/D adversarial trainer. ``configs`` follows ``GanConfig`` plus
    ``generator`` / ``generator_params`` / ``seg_loss`` (the JAX keys).
    ``device``: None builds on the GPU and raises without one; pass
    ``"cpu"`` to train on the CPU."""

    configs: Dict[str, Any]
    logdir: Path = Path("models/_gan")
    seed: int = 1999
    device: Any = None

    def __post_init__(self):
        cfg = self.configs
        self.mesh = P.data_mesh(cfg.get("mesh_shape"),
                                int(cfg.get("batch_size", 2)), self.device)
        self.dp = self.mesh.axis_size() > 1
        if self.device is None and self.mesh.size > 1:
            self.device = self.mesh.device
        self.image_size = int(cfg.get("image_size", 512))
        self.patch_size = int(cfg.get("patch_size", 128))
        self.d_weight = float(cfg.get("d_weight", 0.01))
        self.dtype = torch.float32          # inputs and losses
        self.root = torch.Generator().manual_seed(self.seed)
        self.generator = zoo.get_model(
            cfg.get("generator", "SegFormerStar"),
            dict(cfg.get("generator_params") or {"encoder_name": "mit_b0"}),
            training=True, dtype=torch.float32, device=self.device)
        self.device = next(self.generator.parameters()).device
        self.discriminator = DNet().to(self.device)
        self.seg_loss = L.get_loss(cfg.get("seg_loss", "bce"))
        self.init()

    def init(self) -> None:
        """Draw G and D from ``seed`` and start both optimizers and the step
        count anew (the JAX trainer's ``init``, which every ``fit`` calls)."""
        cfg = self.configs
        zoo.init_flax(self.generator, fold_in(self.root, 0))
        zoo.init_flax(self.discriminator, fold_in(self.root, 2))
        if self.mesh.size > 1:
            P.replicate(self.generator, self.mesh)
            P.replicate(self.discriminator, self.mesh)
        self.g_opt = get_optimizer(
            "adam", [{"params": list(self.generator.parameters()),
                      "lr_mult": 1.0, "weight_decay": GAN_WEIGHT_DECAY}],
            float(cfg.get("g_learning_rate", 1e-4)))
        self.d_opt = get_optimizer(
            "adam", [{"params": list(self.discriminator.parameters()),
                      "lr_mult": 1.0, "weight_decay": GAN_WEIGHT_DECAY}],
            float(cfg.get("d_learning_rate", 1e-4)))
        self.step_count = 0

    # ------------------------------------------------------------------
    def _wire(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))      # a writable copy
        return a.to(self.device, self.dtype)

    def train_step(self, images, masks) -> Dict[str, torch.Tensor]:
        """One D step and one G step on a batch (images (B, H, W, 3) in
        [0, 255], masks (B, H, W) in {0, 1}; host arrays or tensors).
        Returns the four losses as device scalars. Under data parallelism
        this rank's rows of the batch."""
        G, D = self.generator, self.discriminator
        if self.dp:
            rows = P.batch_rows(self.mesh, len(images))
            images, masks = images[rows], masks[rows]
        x = self._wire(images).permute(0, 3, 1, 2)
        m4 = self._wire(masks)
        m4 = m4[:, None] if m4.ndim == 3 else m4.permute(0, 3, 1, 2)
        patch = self.patch_size

        # the discriminator (l.199-208): G in eval mode, no gradient
        G.eval()
        with torch.no_grad():
            fake_mask = torch.sigmoid(_logits(G(x)))
        self.d_opt.zero_grad(set_to_none=True)
        d_real = self._gather(D(image_to_patch(x * m4, patch)))
        d_fake = self._gather(D(image_to_patch(x * fake_mask, patch)))
        d_loss = torch.mean(1.0 - d_real) + torch.mean(d_fake)
        d_loss.backward()
        P.mean_grads(D.parameters(), self.mesh)
        self.d_opt.step()

        # the generator (l.211-217) against the updated discriminator
        G.train()
        set_generator(G, fold_in(self.root, 100 + self.step_count,
                                 self.device))
        D.requires_grad_(False)
        try:
            self.g_opt.zero_grad(set_to_none=True)
            with P.data_parallel(self.mesh):
                logits = _logits(G(x))
                fake = image_to_patch(x * torch.sigmoid(logits), patch)
                seg = self.seg_loss(self._gather(logits).to(self.dtype),
                                    self._gather(m4))
                adv = torch.mean(1.0 - self._gather(D(fake))) * self.d_weight
                g_loss = seg + adv
                g_loss.backward()
            P.mean_grads(G.parameters(), self.mesh)
            self.g_opt.step()
        finally:
            D.requires_grad_(True)
        G.eval()
        self.step_count += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "seg": seg.detach(), "adv": adv.detach()}

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows as the whole batch's (differentiable)."""
        return P.all_gather(t, self.mesh) if self.dp else t

    @torch.inference_mode()
    def predict_probs(self, images) -> torch.Tensor:
        """G's eval forward: (B, H, W) fp32 probabilities."""
        self.generator.eval()
        x = self._wire(images).permute(0, 3, 1, 2)
        return torch.sigmoid(_logits(self.generator(x)).to(self.dtype))[:, 0]

    def evaluate_ap(self, dataset, batch_size: int = 2) -> float:
        """Mean average precision over the images of ``dataset`` whose mask
        is not empty (eval_model, l.93-129); the padded batch's ``n_valid``
        drops the padding. Under data parallelism each rank scores its rows
        and the sums are all-reduced. One host read at the end."""
        sums = torch.zeros(2, device=self.device)
        for batch in batch_iterator(dataset, batch_size, shuffle=False):
            rows = (P.batch_rows(self.mesh, batch_size) if self.dp
                    else slice(0, batch_size))
            probs = self.predict_probs(batch["image"][rows])
            masks = self._wire(batch["mask"][rows])
            for i in range(min(int(batch["n_valid"]) - rows.start,
                               len(probs))):
                has = (masks[i].sum() > 0).float()
                sums[0] += has * M.average_precision(probs[i], masks[i])
                sums[1] += has
        if self.dp:
            sums = P.psum(sums, self.mesh)
        return float(sums[0]) / max(float(sums[1]), 1.0)

    def load_checkpoint(self, path: Union[str, Path]) -> dict:
        """Load a ``best_gan.ckpt`` written by either package into G and D;
        returns ``{"epoch", "step"}``."""
        tree = load_checkpoint(path)
        load_gan(self.generator, self.discriminator, tree)
        return {"epoch": int(tree["epoch"]), "step": int(tree["step"])}

    def fit(self, train_ds, valid_ds, num_epochs: Optional[int] = None,
            batch_size: int = 2) -> Dict[str, Any]:
        """Draw the weights anew (:meth:`init`), then train ``num_epochs``
        (``configs["num_epochs"]``, 200) epochs of shuffled full batches
        (seed ``seed + epoch``), evaluate every
        ``eval_every`` epochs and at the last, keep the best AP's
        ``best_gan.ckpt`` and append each epoch's row to
        ``gan_metrics.jsonl``. Returns ``best_ap``, ``history`` and the
        two models."""
        cfg = self.configs
        num_epochs = num_epochs or int(cfg.get("num_epochs", 200))
        eval_every = int(cfg.get("eval_every", 40))
        logdir = Path(self.logdir)
        main = self.mesh.is_main
        if main:
            logdir.mkdir(parents=True, exist_ok=True)
        self.init()
        best_ap, history = -1.0, []
        for epoch in range(num_epochs):
            t0 = time.time()
            metrics = []
            for batch in batch_iterator(train_ds, batch_size, shuffle=True,
                                        drop_last=True,
                                        seed=self.seed + epoch):
                metrics.append(self.train_step(batch["image"], batch["mask"]))
            agg = {k: float(torch.stack([m[k] for m in metrics]).mean())
                   for k in metrics[0]} if metrics else {}
            row = {"epoch": epoch, **agg, "time": time.time() - t0}
            if (epoch + 1) % eval_every == 0 or epoch == num_epochs - 1:
                ap = self.evaluate_ap(valid_ds, batch_size)
                row["val_ap"] = ap
                if ap > best_ap:
                    best_ap = ap
                    if main:
                        save_checkpoint(logdir / "best_gan.ckpt",
                                        gan_to_flax(self.generator,
                                                    self.discriminator,
                                                    epoch, self.step_count))
            history.append(row)
            if main:
                with open(logdir / "gan_metrics.jsonl", "a") as f:
                    f.write(json.dumps(row) + "\n")
            logger.info("gan epoch %d | d %.4f | g %.4f", epoch,
                        agg.get("d_loss", float("nan")),
                        agg.get("g_loss", float("nan")))
        return {"best_ap": best_ap, "history": history,
                "generator": self.generator,
                "discriminator": self.discriminator}
