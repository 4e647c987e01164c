"""Port parity: the train augmentation ops and policies at JAX's draws.

JAX's PRNG streams cannot be reproduced in torch, so each JAX op's scalars
and noise are derived from its key here, repeating the op's own ``split``
order, and handed to the port's ``apply_*``: images at 1e-4 × 255, masks
exactly. The ``advanced``, ``normal``, ``advanced_vessel``, ``easy``,
``easy_v2`` and ``medium`` policies are compared the same way: every gate, pick and op draw recovered from one key
(for a few keys) and fed to the port policy in its draw order through a
scripted generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.data import transforms as JT
from eyediseasesegmentation_tpu.ops import image as JI
from eyediseasesegmentation_tpu_torch.data import transforms as TT
from eyediseasesegmentation_tpu_torch.ops import image as TI

IMG_TOL = 1e-4 * 255
H, W = 24, 20


def _sample(seed=0, w=W):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (H, w, 3)).astype(np.float32)
    mask = (rng.rand(H, w) < 0.3).astype(np.float32)
    return img, mask


def _u(key, lo, hi):
    return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def _close_img(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=IMG_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_photometric_ops_match_jax(seed):
    img, _ = _sample(seed)
    key = jax.random.PRNGKey(seed)
    x = torch.from_numpy(img)
    _close_img(TI.apply_brightness(x, _u(key, -0.2, 0.2)),
               JI.random_brightness(key, jnp.asarray(img)))
    _close_img(TI.apply_contrast(x, 1.0 + _u(key, -0.2, 0.2)),
               JI.random_contrast(key, jnp.asarray(img)))
    _close_img(TI.apply_gamma(x, _u(key, 0.8, 1.2)),
               JI.random_gamma(key, jnp.asarray(img)))
    k1, k2 = jax.random.split(key)
    z = np.asarray(jax.random.normal(k2, img.shape))
    _close_img(TI.apply_gauss_noise(x, _u(k1, 10.0, 50.0),
                                    torch.from_numpy(z)),
               JI.gauss_noise(key, jnp.asarray(img)))
    np.testing.assert_allclose(
        TI.rgb_to_gray(x, keep_channels=False).numpy(),
        np.asarray(JI.rgb_to_gray(jnp.asarray(img), keep_channels=False)),
        rtol=1e-6, atol=1e-4)


def _ssr_params(key, h, w):
    """shift_scale_rotate's draws from its key: k1..k4, in fp32."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    angle = jax.random.uniform(k1, (), minval=-45.0, maxval=45.0) \
        * jnp.pi / 180.0
    scale = 1.0 + jax.random.uniform(k2, (), minval=-0.1, maxval=0.1)
    dy = jax.random.uniform(k3, (), minval=-0.0625, maxval=0.0625) * h
    dx = jax.random.uniform(k4, (), minval=-0.0625, maxval=0.0625) * w
    return [float(v) for v in (angle, scale, dy, dx)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shift_scale_rotate_matches_jax(seed):
    img, mask = _sample(seed)
    key = jax.random.PRNGKey(10 + seed)
    want_img, want_mask = JI.shift_scale_rotate(key, jnp.asarray(img),
                                                jnp.asarray(mask))
    got_img, got_mask = TI.apply_shift_scale_rotate(
        torch.from_numpy(img), torch.from_numpy(mask),
        *_ssr_params(key, H, W))
    _close_img(got_img, want_img)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scale_matches_jax(seed):
    """RandomScale on JAX's draw: a zoom in or out about the centre."""
    img, mask = _sample(seed)
    key = jax.random.PRNGKey(20 + seed)
    want_img, want_mask = JI.random_scale(key, jnp.asarray(img),
                                          jnp.asarray(mask))
    got_img, got_mask = TI.apply_random_scale(
        torch.from_numpy(img), torch.from_numpy(mask), _u(key, 0.5, 2.0))
    _close_img(got_img, want_img)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert 0.5 <= TI.draw_random_scale(torch.Generator().manual_seed(seed)
                                       ) < 2.0


def test_warp_orders_match_map_coordinates():
    from jax.scipy.ndimage import map_coordinates
    rng = np.random.RandomState(3)
    ch = rng.rand(9, 7).astype(np.float32)
    # coordinates past both edges, on integers and on halves
    cy = np.concatenate([rng.uniform(-2, 11, 40), [0.5, 1.5, -0.5, 2.0]])
    cx = np.concatenate([rng.uniform(-2, 9, 40), [2.5, -1.5, 3.0, 6.5]])
    cy, cx = cy.astype(np.float32), cx.astype(np.float32)
    for order in (0, 1):
        want = map_coordinates(jnp.asarray(ch), [jnp.asarray(cy),
                                                 jnp.asarray(cx)],
                               order=order, mode="nearest")
        got = TI.warp_bilinear(torch.from_numpy(ch), torch.from_numpy(cy),
                               torch.from_numpy(cx), order=order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_nearest_resize_and_pair_geometry_match_jax():
    rng = np.random.RandomState(4)
    mask = (rng.rand(30, 45) < 0.5).astype(np.float32)
    img = rng.uniform(0, 255, (30, 45, 3)).astype(np.float32)
    want_img, want_mask = JT.BaseTransform(32).resize_pair(
        jnp.asarray(img), jnp.asarray(mask))
    got_img, got_mask = TT.BaseTransform(32).resize_pair(
        torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _close_img(got_img, want_img)


class Script:
    """The values a JAX policy drew, in the port policy's draw order:
    stands in for ``ops.image``'s ``uniform``, ``randint`` and
    ``draw_gauss_noise``, and checks each draw's range."""

    def __init__(self):
        self.items = []

    def uniform(self, gen, lo, hi):
        kind, want_lo, want_hi, value = self.items.pop(0)
        assert (kind, want_lo, want_hi) == ("u", lo, hi)
        return value

    def randint(self, gen, lo, hi):
        kind, want_lo, want_hi, value = self.items.pop(0)
        assert (kind, want_lo, want_hi) == ("i", lo, hi)
        return value

    def draw_gauss_noise(self, gen, shape, noise_gen=None, device=None):
        kind, var, z = self.items.pop(0)
        assert kind == "noise" and z.shape == tuple(shape)
        return var, torch.from_numpy(z)

    def draw_elastic(self, noise_gen, h, w, device=None):
        kind, fy, fx = self.items.pop(0)
        assert kind == "elastic" and fy.shape == (h, w, 1)
        return torch.from_numpy(fy), torch.from_numpy(fx)


def _maybe_script(s, key, p, op):
    k_gate, k_fn = jax.random.split(key)
    gate = float(jax.random.uniform(k_gate))
    s.items.append(("u", 0.0, 1.0, gate))
    if gate < p:
        op(s, k_fn)
    return gate < p


def _rot90_script(s, key):
    s.items.append(("i", 0, 4, int(jax.random.randint(key, (), 0, 4))))


def _noise_script(s, key):
    k1, k2 = jax.random.split(key)
    s.items.append(("noise", _u(k1, 10.0, 50.0),
                    np.asarray(jax.random.normal(k2, (H, H, 3)))))


def _ssr_script(s, key):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    for k, lim in ((k1, 45.0), (k2, 0.1), (k3, 0.0625), (k4, 0.0625)):
        s.items.append(("u", -lim, lim, _u(k, -lim, lim)))


def _photometric_script(s, key):
    k_gate, k_pick, k_fn = jax.random.split(key, 3)
    gate = float(jax.random.uniform(k_gate))
    idx = int(jax.random.randint(k_pick, (), 0, 3))
    s.items += [("u", 0.0, 1.0, gate), ("i", 0, 3, idx)]
    if gate < 0.5:
        lo, hi = [(-0.2, 0.2), (0.8, 1.2), (-0.2, 0.2)][idx]
        s.items.append(("u", lo, hi, _u(k_fn, lo, hi)))
    return gate < 0.5


def _advanced_script(s, key):
    ks = jax.random.split(key, 6)
    taken = [_maybe_script(s, ks[0], 0.5, lambda s, k: None),
             _maybe_script(s, ks[1], 0.5, lambda s, k: None),
             _maybe_script(s, ks[2], 0.7, _rot90_script),
             _photometric_script(s, ks[3]),
             _maybe_script(s, ks[4], 0.5, _ssr_script),
             _maybe_script(s, ks[5], 0.5, _noise_script)]
    return taken


def _vessel_script(s, key):
    """advanced_vessel: RandomScale's gate and draw, then advanced."""
    k0, rest = jax.random.split(key)
    taken = _maybe_script(s, k0, 0.5, lambda s, k: s.items.append(
        ("u", 0.5, 2.0, _u(k, 0.5, 2.0))))
    return [taken] + _advanced_script(s, rest)


def _normal_script(s, key):
    ks = jax.random.split(key, 4)
    return [_maybe_script(s, ks[0], 0.5, lambda s, k: None),
            _maybe_script(s, ks[1], 0.5, lambda s, k: None),
            _maybe_script(s, ks[2], 0.7, _rot90_script),
            _maybe_script(s, ks[3], 0.5, _noise_script)]


def _uniforms(s, key, lo, hi, n):
    for v in np.asarray(jax.random.uniform(key, (n,), minval=lo, maxval=hi)):
        s.items.append(("u", lo, hi, float(v)))


def _distortion_script(s, key):
    """OneOf(elastic, grid, optical) at p .5: gate, pick, then the member's
    draws."""
    k_gate, k_pick, k_fn = jax.random.split(key, 3)
    gate = float(jax.random.uniform(k_gate))
    idx = int(jax.random.randint(k_pick, (), 0, 3))
    s.items += [("u", 0.0, 1.0, gate), ("i", 0, 3, idx)]
    if gate < 0.5:
        k1, k2 = jax.random.split(k_fn)
        if idx == 0:
            s.items.append(("elastic", *(np.array(jax.random.uniform(
                k, (H, H, 1), minval=-1, maxval=1)) for k in (k1, k2))))
        elif idx == 1:
            _uniforms(s, k1, -0.3, 0.3, 6)
            _uniforms(s, k2, -0.3, 0.3, 6)
        else:
            k1, k2, k3 = jax.random.split(k_fn, 3)
            for k, lim in ((k1, 2.0), (k2, 0.5), (k3, 0.5)):
                s.items.append(("u", -lim, lim, _u(k, -lim, lim)))
    return (gate < 0.5, idx)


def _bc_script(s, key):
    k1, k2 = jax.random.split(key)
    s.items += [("u", -0.2, 0.2, _u(k1, -0.2, 0.2)),
                ("u", -0.2, 0.2, _u(k2, -0.2, 0.2))]


def _gamma_script(s, key):
    s.items.append(("u", 0.8, 1.2, _u(key, 0.8, 1.2)))


def _easy_script(s, key):
    ks = jax.random.split(key, 6)
    return [_maybe_script(s, ks[0], 0.5, lambda s, k: None),
            _maybe_script(s, ks[1], 0.5, _rot90_script),
            _distortion_script(s, ks[2]),
            _maybe_script(s, ks[3], 0.5, lambda s, k: None),
            _maybe_script(s, ks[4], 0.5, _bc_script),
            _maybe_script(s, ks[5], 0.5, _gamma_script)]


def _easy_v2_script(s, key):
    ks = jax.random.split(key, 5)
    return [_maybe_script(s, ks[0], 0.5, lambda s, k: None),
            _maybe_script(s, ks[1], 0.5, lambda s, k: None),
            _maybe_script(s, ks[2], 0.5, _rot90_script),
            _distortion_script(s, ks[3]),
            _maybe_script(s, ks[4], 0.5, _ssr_script)]


def _medium_script(s, key):
    ks = jax.random.split(key, 7)
    return [_maybe_script(s, ks[0], 0.5, lambda s, k: None),
            _maybe_script(s, ks[1], 0.5, lambda s, k: None),
            _maybe_script(s, ks[2], 0.7, _rot90_script),
            _distortion_script(s, ks[3]),
            _maybe_script(s, ks[4], 0.5, lambda s, k: None),
            _maybe_script(s, ks[5], 0.5, _bc_script),
            _maybe_script(s, ks[6], 0.5, _gamma_script)]


SCRIPTS = {"advanced": _advanced_script, "normal": _normal_script,
           "advanced_vessel": _vessel_script, "easy": _easy_script,
           "easy_v2": _easy_v2_script, "medium": _medium_script}


@pytest.mark.parametrize("policy", ["advanced", "normal", "advanced_vessel",
                                    "easy", "easy_v2", "medium"])
def test_policy_matches_jax_at_its_draws(policy, monkeypatch):
    script = Script()
    for name in ("uniform", "randint", "draw_gauss_noise", "draw_elastic"):
        monkeypatch.setattr(TI, name, getattr(script, name))
    jhard = jax.jit(JT.get_transform(policy)(image_size=H).hard)
    tpol = TT.get_transform(policy)(image_size=H)
    make = SCRIPTS[policy]
    seen = set()
    img, mask = _sample(5, w=H)     # square, as after resize_pair
    for k in range(8):
        key = jax.random.PRNGKey(100 + k)
        seen.add(tuple(make(script, key)))
        want_img, want_mask = jhard(key, jnp.asarray(img),
                                    jnp.asarray(mask))
        got_img, got_mask = tpol.hard(TT.AugRng(torch.Generator()),
                                      torch.from_numpy(img),
                                      torch.from_numpy(mask))
        assert script.items == []          # every draw consumed, in order
        _close_img(got_img, want_img)
        np.testing.assert_array_equal(got_mask.numpy(),
                                      np.asarray(want_mask))
    assert len(seen) > 3                   # the keys took varied branches
    if policy in ("easy", "easy_v2", "medium"):   # two distortions or more
        assert len({t for branches in seen for t in branches
                    if isinstance(t, tuple) and t[0]}) >= 2


def test_unported_policies_raise():
    """Every JAX policy name builds; an unknown name raises ``KeyError``."""
    assert set(TT.TRANSFORM_REGISTRY) == set(JT.TRANSFORM_REGISTRY)
    with pytest.raises(KeyError):
        TT.get_transform("nope")


@pytest.mark.parametrize("p", [0.5, 0.7])
def test_gate_frequencies(p):
    """The port's own draws: over 400 samples a ``_maybe`` gate fires near
    its probability, and ``_one_of`` picks its three members alike."""
    rng = TT.AugRng(torch.Generator().manual_seed(0))
    img, mask = torch.zeros(4, 4, 3), torch.zeros(4, 4)
    fired, picks = [0], [0, 0, 0]

    def op(rng, i, m):
        fired[0] += 1
        return i, m

    def member(j):
        def f(rng, i, m):
            picks[j] += 1
            return i, m
        return f

    for _ in range(400):
        TT._maybe(rng, p, op, img, mask)
        TT._one_of(rng, [member(j) for j in range(3)], img, mask, p=1.0)
    assert abs(fired[0] / 400 - p) < 0.08
    assert all(abs(c / 400 - 1 / 3) < 0.08 for c in picks)
