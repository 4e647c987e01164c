"""Port parity: the TTA predictor (d4, none, flip, hflip, and d4 in vessel
mode) against the JAX ``TTAPredictor``; the aliases the fixed-size
flagship cannot take raise in both packages (the size-free parity of
``multiscale`` / ``five_crop`` / ``ten_crop`` is in test_torch_tiling.py).

Two raw uint8 images of 96×144 at scale_size 64 go through resize + pad +
normalize, the views of the fp32 flagship (shared with
test_torch_flagship.py), the logit merge and the resize back; in vessel mode
(``resize=False``) two 64×64 images are only normalized. Probabilities are
held to 1e-4 (the flagship's own tolerance; the sigmoid does not widen it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyediseasesegmentation_tpu.infer.tta import TTAPredictor as JTTAPredictor
from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

from test_torch_flagship import BASE_DIM, jax_flagship, torch_flagship

CONFIG = {"dataset_name": "IDRiD", "gray": False, "scale_size": 32 * BASE_DIM}


def _raw(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (2, 96, 144, 3)).astype(np.uint8)


@pytest.mark.parametrize("tta,resize", [
    pytest.param("d4", True, id="d4"),
    pytest.param("none", True, id="none"),
    pytest.param("flip", True, id="flip"),
    pytest.param("hflip", True, id="hflip"),
    pytest.param("d4", False, id="d4_no_resize")])
def test_predictor_matches_jax(tta, resize):
    model, variables, _ = jax_flagship()
    raw = _raw(0) if resize else _raw(0)[:, :64, :64]
    hw = raw.shape[1:3]
    jp = JTTAPredictor(model, variables, CONFIG, tta=tta, ori_hw=hw,
                       resize=resize)
    want = np.asarray(jp._predict_jit(jnp.asarray(raw)))
    got = TTAPredictor(torch_flagship(), CONFIG, tta=tta, ori_hw=hw,
                       resize=resize).predict(raw)
    assert got.shape == want.shape == (2, *hw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_unported_aliases_and_mixed_sizes_raise():
    """The axial flagship takes one input size: where an alias feeds it
    another (``multiscale``'s monolithic scale-2 leg at the default
    ``multiscale_max_res``, the half-size crops), JAX raises ValueError
    while tracing and the port raises it too. Unknown aliases and a batch
    of another size than the pinned ``ori_hw`` raise as well."""
    jmodel, variables, _ = jax_flagship()
    model = torch_flagship()
    raw = _raw(2)[:1]
    for alias in ("multiscale", "five_crop", "ten_crop"):
        with pytest.raises(ValueError):
            JTTAPredictor(jmodel, variables, CONFIG, tta=alias,
                          ori_hw=raw.shape[1:3]).predict(raw)
        with pytest.raises(ValueError, match="relative-position"):
            TTAPredictor(model, CONFIG, tta=alias,
                         ori_hw=raw.shape[1:3]).predict(raw)
    with pytest.raises(KeyError, match="Unknown TTA alias"):
        TTAPredictor(model, CONFIG, tta="d8")
    predictor = TTAPredictor(model, CONFIG, tta="d4", ori_hw=(96, 144))
    with pytest.raises(ValueError, match="ori_hw"):
        predictor.predict(_raw(2)[:, :80])
