"""Plain reference of one training step of the flagship.

The ``advanced`` augmentation per sample (hflip .5, vflip .5, rot90 .7,
one of contrast / gamma / brightness .5, shift-scale-rotate .5, Gaussian
noise .5), drawn as the program draws it: gates, picks and scalars from a
CPU generator, the noise field from a device generator, both made from the
epoch generator's seed and the step count by splitmix64; then the
normalisation, the forward in train mode (batch statistics in the unfrozen
norms, DropBlock from a third generator), the loss 0.8·BCE + 0.2·(−log
soft dice), the backward, and AdamW (β 0.9 / 0.999, ε 1e-5, decoupled
weight decay) over the flagship's groups: relative position tables at
lr × 1 and no decay, the encoder but layer4 at lr × 0.1, the rest at lr.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as R
from perfbench.reference.tta import normalise

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-5
LUMA = (0.2989, 0.5870, 0.1140)


def fold_in(gen: torch.Generator, data: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded by splitmix64 of ``gen``'s seed and
    ``data``."""
    m64 = (1 << 64) - 1
    z = (gen.initial_seed() + 0x9E3779B97F4A7C15 * (int(data) + 1)) & m64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
    return torch.Generator(device=device).manual_seed(
        (z ^ (z >> 31)) & ((1 << 63) - 1))


def uniform(gen, lo, hi) -> float:
    u = torch.rand((), generator=gen).item()
    return float(np.float32(u) * np.float32(hi - lo) + np.float32(lo))


def randint(gen, lo, hi) -> int:
    return int(torch.randint(lo, hi, (), generator=gen).item())


def warp(img, sy, sx, nearest: bool):
    """Sample (H, W[, C]) at (sy, sx) with edge clamp: bilinear, or nearest
    with halves away from zero."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]
    if nearest:
        iy = (torch.sign(sy) * torch.floor(sy.abs() + 0.5)).long()
        ix = (torch.sign(sx) * torch.floor(sx.abs() + 0.5)).long()
        out = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    else:
        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = sy - y0, sx - x0
        y0, x0 = y0.long(), x0.long()
        out = 0
        for iy, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
            for ix, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
                out = out + (wy * wx)[..., None] * img[iy.clamp(0, h - 1),
                                                       ix.clamp(0, w - 1)]
    return out[..., 0] if squeeze else out


def shift_scale_rotate(img, mask, gen):
    f32 = np.float32
    h, w = img.shape[0], img.shape[1]
    angle = f32(uniform(gen, -45.0, 45.0)) * f32(math.pi) / f32(180.0)
    scale = f32(1.0) + f32(uniform(gen, -0.1, 0.1))
    dy = f32(uniform(gen, -0.0625, 0.0625)) * f32(h)
    dx = f32(uniform(gen, -0.0625, 0.0625)) * f32(w)
    kw = dict(dtype=torch.float32, device=img.device)
    gy = torch.arange(h, **kw)[:, None].expand(h, w)
    gx = torch.arange(w, **kw)[None, :].expand(h, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = torch.tensor(float(angle), **kw)
    cos, sin = torch.cos(a), torch.sin(a)
    oy = gy - cy - torch.tensor(float(dy), **kw)
    ox = gx - cx - torch.tensor(float(dx), **kw)
    s = torch.tensor(float(scale), **kw)
    sy = (cos * oy - sin * ox) / s + cy
    sx = (sin * oy + cos * ox) / s + cx
    return warp(img, sy, sx, False), warp(mask, sy, sx, True)


def photometric(idx: int, img, gen):
    if idx == 0:                                          # contrast
        alpha = float(np.float32(1.0) + np.float32(uniform(gen, -0.2, 0.2)))
        luma = torch.tensor(LUMA, dtype=img.dtype, device=img.device)
        mean = (img[..., :3] * luma).sum(-1).mean()
        return (img * alpha + mean * (1.0 - alpha)).clamp(0.0, 255.0)
    if idx == 1:                                          # gamma
        g = uniform(gen, 0.8, 1.2)
        return (((img / 255.0) ** g) * 255.0).clamp(0.0, 255.0)
    a = uniform(gen, -0.2, 0.2)                           # brightness
    return (img * (1.0 + a)).clamp(0.0, 255.0)


def advanced(img, mask, host: torch.Generator, dev: torch.Generator):
    """One sample (H, W, 3) float [0, 255], (H, W) float {0, 1}."""
    if uniform(host, 0.0, 1.0) < 0.5:
        img, mask = img.flip(1), mask.flip(1)
    if uniform(host, 0.0, 1.0) < 0.5:
        img, mask = img.flip(0), mask.flip(0)
    if uniform(host, 0.0, 1.0) < 0.7:
        k = randint(host, 0, 4)
        img = torch.rot90(img, k, dims=(0, 1))
        mask = torch.rot90(mask, k, dims=(0, 1))
    apply = uniform(host, 0.0, 1.0) < 0.5
    idx = randint(host, 0, 3)
    if apply:
        img = photometric(idx, img, host)
    if uniform(host, 0.0, 1.0) < 0.5:
        img, mask = shift_scale_rotate(img, mask, host)
    if uniform(host, 0.0, 1.0) < 0.5:
        var = uniform(host, 10.0, 50.0)
        z = torch.randn(img.shape, generator=dev, device=img.device)
        img = (img + z * math.sqrt(var)).clamp(0.0, 255.0)
    return img, mask


def augment(images, masks, step_gen: torch.Generator, dataset: str):
    """The step's batch (uint8 on the device) augmented and normalised:
    (N, 3, H, W) float32 and (N, 1, H, W) float32."""
    host = fold_in(step_gen, 0)
    dev = fold_in(step_gen, 1, images.device)
    outs = [advanced(images[i].float(), masks[i].float(), host, dev)
            for i in range(images.shape[0])]
    x = normalise(torch.stack([o[0] for o in outs]), dataset)
    return x.permute(0, 3, 1, 2), torch.stack([o[1] for o in outs])[:, None]


def loss_fn(logits, target):
    """0.8 · mean BCE-with-logits + 0.2 · (−log soft dice over the
    batch)."""
    bce = F.binary_cross_entropy_with_logits(logits, target)
    p = torch.sigmoid(logits)
    inter = (p * target).sum()
    card = (p + target).sum()
    dice = 2.0 * inter / card.clamp(min=1e-7)
    log_dice = -torch.log(dice.clamp(min=1e-7)) * (target.sum() > 0)
    return 0.8 * bce + 0.2 * log_dice


def group_of(name: str) -> Tuple[float, float]:
    """A parameter's (lr multiplier, weight-decay multiplier)."""
    if "pos_enc" in name:
        return 1.0, 0.0
    if "encoder" in name and "layer4" not in name:
        return 0.1, 1.0
    return 1.0, 1.0


def groups(model) -> Dict[str, Tuple[float, float]]:
    """name → (lr multiplier, weight-decay multiplier)."""
    return {name: group_of(name) for name, _ in model.named_parameters()}


class AdamW:
    def __init__(self, model, lr: float, weight_decay: float):
        self.params = dict(model.named_parameters())
        self.mult = groups(model)
        self.lr, self.wd = lr, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for n, p in self.params.items():
            g = p.grad
            lr_m, wd_m = self.mult[n]
            lr = self.lr * lr_m
            self.m[n].mul_(B1).add_(g, alpha=1 - B1)
            self.v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
            p.mul_(1 - lr * self.wd * wd_m)
            denom = self.v[n].sqrt() / math.sqrt(c2) + ADAM_EPS
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def step_input(images, masks, epoch_gen: torch.Generator, step: int,
               dataset: str, dtype):
    """(the step's generator, augmented images, masks) in ``dtype``."""
    g = fold_in(epoch_gen, step)
    x, m = augment(images, masks, g, dataset)
    return g, x.to(dtype), m.to(dtype)


def train_steps(model, opt: AdamW, batches: List[Tuple[torch.Tensor,
                                                       torch.Tensor]],
                epoch_gen: torch.Generator, dataset: str):
    """Steps 0, 1, ... over ``batches`` (uint8 images and masks on the
    device). Returns (losses, the first step's gradients by name, the
    first step's logits)."""
    model.train()
    losses, first, logits0 = [], None, None
    dt = next(model.parameters()).dtype
    for step, (images, masks) in enumerate(batches):
        g, x, m = step_input(images, masks, epoch_gen, step, dataset, dt)
        R.set_generator(model, fold_in(g, 2, images.device))
        for p in model.parameters():
            p.grad = None
        logits = model(x)
        loss = loss_fn(logits, m)
        loss.backward()
        if first is None:
            first = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            logits0 = logits.detach().float().clone()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first, logits0


@torch.no_grad()
def first_logits(model, images, masks, epoch_gen: torch.Generator,
                 dataset: str) -> torch.Tensor:
    """The first step's train-mode forward alone (no update), in the
    model's dtype; the logits in float32."""
    model.train()
    dt = next(model.parameters()).dtype
    g, x, _ = step_input(images, masks, epoch_gen, 0, dataset, dt)
    R.set_generator(model, fold_in(g, 2, images.device))
    return model(x).float()
