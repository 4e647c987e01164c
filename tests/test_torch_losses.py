"""Port parity: the loss registry against the JAX package.

Every one of the 14 names of ``get_loss`` and ``compound_loss`` on the
default criterion, on the same numpy-seeded logits and targets (NHWC for
JAX, NCHW for the port): the value at 1e-6 relative and the gradient with
respect to the logits at 1e-5 of its max. The logits hold ties (values
rounded to a coarse grid), which the Lovász and top-k sorts must order as
JAX does. The five losses with ``ignore_index`` run with and without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.ops import losses as JL
from eyediseasesegmentation_tpu_torch.ops import losses as TL

NAMES = ["kl", "topk", "bce", "wbce", "log_bce", "ce", "soft_bce", "focal",
         "jaccard", "log_jaccard", "dice", "log_dice", "lovasz",
         "symmetric_lovasz"]
VALUE_RTOL, GRAD_TOL = 1e-6, 1e-5
# the ignored label: inside [0, 1], so that the focal term of an ignored
# pixel stays finite on both sides before the mask zeroes it
IGNORE = 0.5


def _inputs(name, ignore):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "ce":
        logits = rng.randn(2, 8, 6, 3).astype(np.float32)
        targets = rng.randint(0, 3, (2, 8, 6)).astype(np.float32)
        return logits, targets
    # ties: logits on a 0.25 grid, so many pixels share one error
    logits = (np.round(rng.randn(2, 8, 6, 1) * 4) / 4).astype(np.float32)
    targets = (rng.rand(2, 8, 6, 1) < 0.3).astype(np.float32)
    if ignore:
        targets[0, :2] = IGNORE
    return logits, targets


def _nchw(a):
    return torch.from_numpy(np.moveaxis(a, -1, 1).copy()) if a.ndim == 4 \
        else torch.from_numpy(a.copy())


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name):
    ignore = name in ("bce", "wbce", "log_bce", "soft_bce", "focal")
    for ignore_index in ([None, IGNORE] if ignore else [None]):
        logits, targets = _inputs(name, ignore_index is not None)
        jfn = JL.get_loss(name, ignore_index=ignore_index, pos_weights=[3.0])
        tfn = TL.get_loss(name, ignore_index=ignore_index, pos_weights=[3.0])
        jt = jnp.asarray(targets)
        want, jgrad = jax.jit(jax.value_and_grad(lambda x: jfn(x, jt)))(
            jnp.asarray(logits))
        x = _nchw(logits).requires_grad_(True)
        got = tfn(x, _nchw(targets))
        got.backward()
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=VALUE_RTOL, atol=1e-7)
        tgrad = np.moveaxis(x.grad.numpy(), 1, -1)
        jgrad = np.asarray(jgrad)
        assert np.abs(tgrad - jgrad).max() <= GRAD_TOL * np.abs(jgrad).max()


def test_compound_loss_matches_jax():
    logits, targets = _inputs("compound", False)
    criterion = {"bce": 0.8, "log_dice": 0.2}
    jfn = JL.compound_loss(criterion, pos_weights=[500.0])
    tfn = TL.compound_loss(criterion, pos_weights=[500.0])
    want, want_parts = jfn(jnp.asarray(logits), jnp.asarray(targets))
    got, parts = tfn(_nchw(logits), _nchw(targets))
    assert sorted(parts) == sorted(want_parts) == sorted(criterion)
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL)
    for k in criterion:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   rtol=VALUE_RTOL)


def test_bce_reads_no_pos_weights():
    """Only ``wbce`` reads ``pos_weights``: ``bce`` is the plain soft BCE."""
    logits, targets = _inputs("bce", False)
    x, t = _nchw(logits), _nchw(targets)
    plain = TL.get_loss("bce")(x, t)
    assert float(TL.get_loss("bce", pos_weights=[500.0])(x, t)) == \
        float(plain)
    assert float(TL.get_loss("wbce", pos_weights=[500.0])(x, t)) > \
        2 * float(plain)
