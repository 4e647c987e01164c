"""Augmentation policies and the eval-time transform (torch port).

Counterpart of ``eyediseasesegmentation_tpu/data/transforms.py``. A policy
maps ``(image[H, W, C] float 0..255, mask[H, W] float 0/1)`` to the same at
``image_size``: ``train`` resizes (LongestMaxSize + centre pad, the mask
nearest), applies the policy's ``hard`` augmentation and normalizes;
``test`` resizes and normalizes. Eager torch branches natively, so the
stochastic gates (``_maybe``, ``_one_of``, ``_rot90``) are Python branches
taken one sample at a time, and only the taken op runs.

Randomness comes from an :class:`AugRng`: a CPU generator for the gate and
pick decisions and the ops' scalars (drawing them never waits for the
device) and a generator on the images' device for noise fields. The draw
order of a policy is fixed: one gate (and pick) per member, in the order
the JAX policy lists them, then the member's own draws when it is taken.

All seven JAX policies are here: ``none``, ``normal``, ``easy``,
``easy_v2``, ``medium``, ``advanced`` and ``advanced_vessel``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops import image as I


@dataclasses.dataclass
class AugRng:
    """The generators of one augmentation call: ``host`` on the CPU (gates,
    picks, scalars), ``device`` where the images live (noise fields;
    ``None``: that device's default generator)."""

    host: torch.Generator
    device: Optional[torch.Generator] = None


Pair = Tuple[torch.Tensor, torch.Tensor]


def _maybe(rng: AugRng, p: float, fn, img, mask) -> Pair:
    """Apply ``fn`` with probability ``p``."""
    if I.uniform(rng.host, 0.0, 1.0) < p:
        return fn(rng, img, mask)
    return img, mask


def _one_of(rng: AugRng, fns, img, mask, p: float) -> Pair:
    """albumentations OneOf: with probability ``p`` apply one member picked
    uniformly."""
    apply = I.uniform(rng.host, 0.0, 1.0) < p
    idx = I.randint(rng.host, 0, len(fns))
    return fns[idx](rng, img, mask) if apply else (img, mask)


def _vflip(rng, img, mask):
    return I.vflip(img), I.vflip(mask[..., None])[..., 0]


def _hflip(rng, img, mask):
    return I.hflip(img), I.hflip(mask[..., None])[..., 0]


def _rot90(rng, img, mask):
    """RandomRotate90: k ~ uniform{0..3}."""
    k = I.randint(rng.host, 0, 4)
    if k == 0:
        return img, mask
    return I.rot90(img, k), I.rot90(mask[..., None], k)[..., 0]


def _contrast(rng, img, mask):
    return I.apply_contrast(img, I.draw_contrast(rng.host)), mask


def _gamma(rng, img, mask):
    return I.apply_gamma(img, I.draw_gamma(rng.host)), mask


def _brightness(rng, img, mask):
    return I.apply_brightness(img, I.draw_brightness(rng.host)), mask


def _gauss_noise(rng, img, mask):
    var, z = I.draw_gauss_noise(rng.host, img.shape, rng.device, img.device)
    return I.apply_gauss_noise(img, var, z), mask


def _shift_scale_rotate(rng, img, mask):
    params = I.draw_shift_scale_rotate(rng.host, img.shape[0], img.shape[1])
    return I.apply_shift_scale_rotate(img, mask, *params)


def _random_scale(rng, img, mask):
    return I.apply_random_scale(img, mask, I.draw_random_scale(rng.host))


def _elastic(rng, img, mask):
    fy, fx = I.draw_elastic(rng.device, img.shape[0], img.shape[1],
                            img.device)
    return I.apply_elastic(img, mask, fy, fx, alpha=120.0, sigma=120 * 0.05)


def _grid_distortion(rng, img, mask):
    return I.apply_grid_distortion(img, mask,
                                   *I.draw_grid_distortion(rng.host))


def _optical_distortion(rng, img, mask):
    params = I.draw_optical_distortion(rng.host, img.shape[0], img.shape[1],
                                       distort_limit=2.0, shift_limit=0.5)
    return I.apply_optical_distortion(img, mask, *params)


def _clahe(rng, img, mask):
    return I.clahe_rgb(img), mask


def _brightness_contrast(rng, img, mask):
    img, mask = _brightness(rng, img, mask)
    return _contrast(rng, img, mask)


PHOTOMETRIC = (_contrast, _gamma, _brightness)
DISTORTIONS = (_elastic, _grid_distortion, _optical_distortion)


class BaseTransform:
    """``train(img, mask, rng)`` = resize → hard augmentation → normalize;
    ``test(img)`` = resize → normalize. Images enter as float [0, 255] of
    any size, channel last, and leave at (image_size, image_size)."""

    def __init__(self, image_size: int = 1024,
                 preprocessing_fn: Optional[Callable] = None):
        self.image_size = image_size
        self.preprocessing_fn = preprocessing_fn

    def resize(self, img: torch.Tensor) -> torch.Tensor:
        return I.longest_max_size_pad(img, self.image_size)

    def resize_pair(self, img: torch.Tensor, mask: torch.Tensor) -> Pair:
        m = mask[..., None] if mask.ndim == 2 else mask
        m = I.longest_max_size_pad(m, self.image_size, method="nearest")
        return self.resize(img), (m[..., 0] if mask.ndim == 2 else m)

    def hard(self, rng: AugRng, img, mask) -> Pair:
        return img, mask

    def train(self, img, mask, rng: AugRng) -> Pair:
        img, mask = self.resize_pair(img, mask)
        img, mask = self.hard(rng, img, mask)
        if self.preprocessing_fn is not None:
            img = self.preprocessing_fn(img)
        return img, mask

    def test(self, img: torch.Tensor) -> torch.Tensor:
        img = self.resize(img)
        if self.preprocessing_fn is not None:
            img = self.preprocessing_fn(img)
        return img

    def batch_train(self, imgs, masks, rng: AugRng,
                    rows: Optional[slice] = None) -> Pair:
        """One sample at a time, in batch order, from one ``rng``.

        ``rows``: return only these samples of the batch (a rank's share
        under data parallelism); ``imgs`` / ``masks`` need to hold the
        batch up to ``rows.stop``. The samples before them are augmented
        too, so that the draws each kept sample sees are the ones it sees
        in the whole batch, and one seed gives one augmented global batch
        at every world size."""
        stop = imgs.shape[0] if rows is None else rows.stop
        outs = [self.train(imgs[i], masks[i], rng) for i in range(stop)]
        outs = outs[rows] if rows is not None else outs
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))


class NoOpTransform(BaseTransform):
    """Resize and normalize only."""


class NormalTransform(BaseTransform):
    """vflip .5, hflip .5, rot90 .7, GaussNoise .5."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _vflip, img, mask)
        img, mask = _maybe(rng, 0.5, _hflip, img, mask)
        img, mask = _maybe(rng, 0.7, _rot90, img, mask)
        img, mask = _maybe(rng, 0.5, _gauss_noise, img, mask)
        return img, mask


class EasyTransform(BaseTransform):
    """vflip .5, rot90 .5, OneOf(elastic, grid, optical) .5, CLAHE .5,
    brightness then contrast .5, gamma .5 (data_transform.py:77-94)."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _vflip, img, mask)
        img, mask = _maybe(rng, 0.5, _rot90, img, mask)
        img, mask = _one_of(rng, DISTORTIONS, img, mask, p=0.5)
        img, mask = _maybe(rng, 0.5, _clahe, img, mask)
        img, mask = _maybe(rng, 0.5, _brightness_contrast, img, mask)
        img, mask = _maybe(rng, 0.5, _gamma, img, mask)
        return img, mask


class EasyTransformV2(BaseTransform):
    """vflip, hflip, rot90 .5 each, OneOf(elastic, grid, optical) .5,
    ShiftScaleRotate .5 (data_transform.py:96-112)."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _vflip, img, mask)
        img, mask = _maybe(rng, 0.5, _hflip, img, mask)
        img, mask = _maybe(rng, 0.5, _rot90, img, mask)
        img, mask = _one_of(rng, DISTORTIONS, img, mask, p=0.5)
        img, mask = _maybe(rng, 0.5, _shift_scale_rotate, img, mask)
        return img, mask


class MediumTransform(BaseTransform):
    """vflip .5, hflip .5, rot90 .7, OneOf(elastic, grid, optical) .5,
    CLAHE .5, brightness then contrast .5, gamma .5
    (data_transform.py:114-132)."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _vflip, img, mask)
        img, mask = _maybe(rng, 0.5, _hflip, img, mask)
        img, mask = _maybe(rng, 0.7, _rot90, img, mask)
        img, mask = _one_of(rng, DISTORTIONS, img, mask, p=0.5)
        img, mask = _maybe(rng, 0.5, _clahe, img, mask)
        img, mask = _maybe(rng, 0.5, _brightness_contrast, img, mask)
        img, mask = _maybe(rng, 0.5, _gamma, img, mask)
        return img, mask


class AdvancedTransform(BaseTransform):
    """hflip .5, vflip .5, rot90 .7, OneOf(contrast, gamma, brightness) .5,
    ShiftScaleRotate .5, GaussNoise .5 (the reference's distortion OneOf
    has p = 0 and is left out, as in the JAX policy)."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _hflip, img, mask)
        img, mask = _maybe(rng, 0.5, _vflip, img, mask)
        img, mask = _maybe(rng, 0.7, _rot90, img, mask)
        img, mask = _one_of(rng, PHOTOMETRIC, img, mask, p=0.5)
        img, mask = _maybe(rng, 0.5, _shift_scale_rotate, img, mask)
        img, mask = _maybe(rng, 0.5, _gauss_noise, img, mask)
        return img, mask


class AdvancedTransformVessel(AdvancedTransform):
    """RandomScale[0.5, 2] at p .5 (a scale-about-centre warp at the same
    shape) before the advanced policy (data_transform.py:134-156)."""

    def hard(self, rng, img, mask):
        img, mask = _maybe(rng, 0.5, _random_scale, img, mask)
        return super().hard(rng, img, mask)


TRANSFORM_REGISTRY = {
    "none": NoOpTransform,
    "normal": NormalTransform,
    "easy": EasyTransform,
    "easy_v2": EasyTransformV2,
    "medium": MediumTransform,
    "advanced": AdvancedTransform,
    "advanced_vessel": AdvancedTransformVessel,
}


def get_transform(name: str):
    """Policy registry, the JAX package's names."""
    try:
        return TRANSFORM_REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown transform '{name}'. Options: "
                       f"{sorted(TRANSFORM_REGISTRY)}") from None
