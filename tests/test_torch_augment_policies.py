"""Port parity: the ops of the ``easy``, ``easy_v2`` and ``medium`` policies.

The elastic, grid and optical distortions at the values a JAX key draws
(recovered by repeating the op's own ``split`` order) through the port's
``apply_*``, at 24×20 and 64×64: images within 1e-4 × 255; masks equal
except at pixels whose JAX source coordinate lies within ``EDGE`` px of a
nearest-rounding boundary (two fp32 paths to the same coordinate may round
such a pixel either way), which are counted and bounded. The source
coordinates come from the JAX op itself: bilinear sampling of a ramp
image returns the coordinate. The Gaussian blur, CLAHE (one ``bincount``
per image in the port, a one-hot sum in JAX), ``clahe_rgb``,
``ben_color_device`` and ``binarize_mask`` against JAX. The policies
themselves are held at JAX's draws in ``tests/test_torch_augment.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.ops import image as JI
from eyediseasesegmentation_tpu_torch.ops import image as TI

IMG_TOL = 1e-4 * 255
EDGE = 1e-3                # px from a .5 rounding boundary
SIZES = [(24, 20), (64, 64)]


def _sample(h, w, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = (rng.rand(h, w) < 0.3).astype(np.float32)
    return img, mask


def _u(key, lo, hi, shape=()):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _close(got, want, tol=IMG_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def _source_coords(op, key, h, w):
    """(sy, sx) the JAX op samples at: its bilinear warp of the ramps."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ramp = np.stack([gy, gx], -1).astype(np.float32)
    out = np.asarray(op(key, jnp.asarray(ramp)))
    return out[..., 0], out[..., 1]


def _mask_agrees(got, want, sy, sx):
    """Equal masks, except at pixels whose source coordinate is within
    ``EDGE`` of a rounding boundary; returns how many of those differ."""
    got, want = got.numpy(), np.asarray(want)
    near = ((np.abs(sy - np.floor(sy) - 0.5) < EDGE)
            | (np.abs(sx - np.floor(sx) - 0.5) < EDGE))
    bad = got != want
    assert not (bad & ~near).any(), np.argwhere(bad & ~near)[:5]
    return int(bad.sum())


def _elastic(key, h, w):
    k1, k2 = jax.random.split(key)
    fy = np.array(_u(k1, -1, 1, (h, w, 1)))
    fx = np.array(_u(k2, -1, 1, (h, w, 1)))
    return torch.from_numpy(fy), torch.from_numpy(fx)


def _grid(key, h, w):
    k1, k2 = jax.random.split(key)
    return ([float(v) for v in 1.0 + jnp.asarray(_u(k1, -0.3, 0.3, (6,)))],
            [float(v) for v in 1.0 + jnp.asarray(_u(k2, -0.3, 0.3, (6,)))])


def _optical(key, h, w):
    k1, k2, k3 = jax.random.split(key, 3)
    k = jax.random.uniform(k1, (), minval=-2.0, maxval=2.0)
    dy = jax.random.uniform(k2, (), minval=-0.5, maxval=0.5) * h * 0.1
    dx = jax.random.uniform(k3, (), minval=-0.5, maxval=0.5) * w * 0.1
    return float(k), float(dy), float(dx)


OPS = {
    "elastic": (lambda k, i, m=None: JI.elastic_transform(
        k, i, m, alpha=120.0, sigma=6.0), _elastic,
        lambda i, m, p: TI.apply_elastic(i, m, *p, alpha=120.0, sigma=6.0)),
    "grid": (JI.grid_distortion, _grid,
             lambda i, m, p: TI.apply_grid_distortion(i, m, *p)),
    "optical": (JI.optical_distortion, _optical,
                lambda i, m, p: TI.apply_optical_distortion(i, m, *p)),
}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(OPS))
def test_distortion_matches_jax(name, size):
    jop, draws, top = OPS[name]
    h, w = size
    near_total, pixels = 0, 0
    for seed in range(3):
        img, mask = _sample(h, w, seed)
        key = jax.random.PRNGKey(40 + seed)
        want_img, want_mask = jop(key, jnp.asarray(img), jnp.asarray(mask))
        got_img, got_mask = top(torch.from_numpy(img),
                                torch.from_numpy(mask), draws(key, h, w))
        _close(got_img, want_img)
        sy, sx = _source_coords(jop, key, h, w)
        near_total += _mask_agrees(got_mask, want_mask, sy, sx)
        pixels += h * w
    assert near_total <= max(2, pixels // 500)


def test_draws_are_in_range():
    gen = torch.Generator().manual_seed(0)
    fy, fx = TI.draw_elastic(None, 9, 7)
    assert fy.shape == fx.shape == (9, 7, 1)
    assert float(fy.min()) >= -1 and float(fy.max()) < 1
    sy, sx = TI.draw_grid_distortion(gen)
    assert len(sy) == len(sx) == 6 and all(0.7 <= v <= 1.3 for v in sy + sx)
    k, dy, dx = TI.draw_optical_distortion(gen, 40, 20)
    assert abs(k) <= 2 and abs(dy) <= 2 and abs(dx) <= 1


def test_interp_and_linspace_match_jnp():
    rng = np.random.RandomState(1)
    xp = np.sort(rng.uniform(0, 10, 7)).astype(np.float32)
    xp[3] = xp[2]                            # a flat step
    fp = rng.uniform(-3, 3, 7).astype(np.float32)
    x = np.concatenate([rng.uniform(-1, 11, 50), xp]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = TI.interp(torch.from_numpy(x), torch.from_numpy(xp),
                    torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for size in (20, 24, 64, 608, 1024, 2048):    # within two ulps
        np.testing.assert_allclose(
            TI._linspace(float(size - 1), 7, "cpu").numpy(),
            np.asarray(jnp.linspace(0, size - 1, 7)), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_blur_and_colour_ops_match_jax(size):
    h, w = size
    img, mask = _sample(h, w, 3)
    x = torch.from_numpy(img)
    for sigma in (1.0, 6.0, 30.0):            # the radius cut to the map
        _close(TI.gaussian_blur(x, sigma), JI.gaussian_blur(
            jnp.asarray(img), sigma), tol=1e-4)
    _close(TI.ben_color_device(x), JI.ben_color_device(jnp.asarray(img)))
    np.testing.assert_allclose(TI.gaussian_kernel_1d(2.5, 4).numpy(),
                               np.asarray(JI.gaussian_kernel_1d(2.5, 4)),
                               rtol=1e-6)
    m = mask * 100.0
    np.testing.assert_array_equal(TI.binarize_mask(torch.from_numpy(m)).numpy(),
                                  np.asarray(JI.binarize_mask(jnp.asarray(m))))


@pytest.mark.parametrize("size", SIZES + [(70, 45)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_clahe_matches_jax(size):
    """Gray CLAHE (tiles that do not divide the map included) and the RGB
    form; the port's counts equal JAX's one-hot sums."""
    h, w = size
    img, _ = _sample(h, w, 5)
    gray = np.round(img[..., 0] * 0.9).astype(np.float32)   # integral
    for clip in (4.0, 1.0):
        _close(TI.clahe(torch.from_numpy(gray), clip),
               JI.clahe(jnp.asarray(gray), clip))
    _close(TI.clahe_rgb(torch.from_numpy(img)),
           JI.clahe_rgb(jnp.asarray(img)))
