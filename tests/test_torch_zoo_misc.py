"""Port parity: ``misc.py``'s families without an encoder trunk (the MedT
axial U-Nets, HED-UNet, DC-UNet, ResUNet++) against the JAX package at
64² in fp32, as ``test_torch_zoo_extra.check_family`` holds them: the
port's weights drawn by ``init_random`` and carried to JAX by
``convert.torch_to_flax``, one variable tree, every output within 1e-4 ×
max|output| (``test_torch_zoo_misc_encoders.py`` holds the rest).

The MedT models are built for ``input_size`` 64 (their position tables
follow the map each block receives; MedT's local branch is built for
64 / ``patch_grid``). At ``base`` 8 the first blocks have 4 channels: 2
heads of value width 2 and query width 4, so dq > dh. Small cases hold
the gated axial attention alone in bf16 (the scores turn fp32 where JAX's
do), a train-mode MedT block with its moved ``qkv_bn`` statistics and the
HED-UNet blocks with deep supervision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.models import misc as jmisc
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.models import misc as tmisc
from test_torch_zoo import _flat
from test_torch_zoo_extra import (_hold, _input, _jax_forward,
                                  _port_variables, check_family)

SMALL_TOL = 1e-5                 # × max|output|, fp32, one block
# bf16, one attention: the port and JAX round the same products; a bf16
# rounding of the scores (up to 0.25 at |logit| ~ 64) is far outside
BF16_TOL = 1e-2                  # × max|output|
AT_64 = {"input_size": 64}
NARROW = {"filters": [8, 16, 32]}

# (registry name, model params, input side)
FAMILIES = {
    "gated": ("gated", {"base": 8, **AT_64}, 64),
    "axialatt_unet": ("axialatt_unet", {"base": 8, **AT_64}, 64),
    "axialattwopo_unet": ("axialattwopo_unet", {"base": 8}, 64),
    "medt": ("medt", {"base": 8, "patch_grid": 2, **AT_64}, 64),
    "dcunet": ("dcunet", NARROW, 64),
    "resunetplusplus": ("resunetplusplus", NARROW, 64),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    check_family(*FAMILIES[family])


@pytest.mark.parametrize("name", ["hed_unet", "hed_resunet",
                                  "hed_denseunet"])
def test_hed_blocks_with_deep_supervision_match_jax(name):
    """Each HED block at ``base`` 4, ``depth`` 3, built with deep
    supervision (``training=True`` keeps it) and run in eval: the merged
    segmentation and the two coarser side outputs, against JAX."""
    params = {"base": 4, "depth": 3, "deep_supervision": True}
    x = _input(64)
    tmodel, variables = _port_variables(name, params, training=True)
    jmodel = jzoo.get_model(name, params, training=True, dtype=jnp.float32)
    want = _flat(_jax_forward(jmodel, variables, jnp.asarray(x),
                              train=False))
    with torch.no_grad():
        got = _flat(tmodel(_nchw(x)))
    assert len(got) == 3 and all(g.shape == (1, 64, 64, 1) for g in got)
    _hold(got, want, name)


def _random_block(module, seed):
    tzoo.init_random(module, torch.Generator().manual_seed(seed))
    return module, torch_to_flax(module)


def test_gated_axial_attention_bf16_matches_jax():
    """``GatedAxialAttention`` alone in bf16 (C 16: 8 heads, dh 2, dq 4)
    against JAX's in bf16, with logits of a few tens: JAX's scores turn
    fp32 at the division by √dq and its gated terms are fp32, so the port
    must not round them to bf16 (that is off by far more than
    ``BF16_TOL``). Its flax tree: ``to_qkv`` / ``to_out`` Dense scopes, the
    four 0-d gates, ``relative`` (2·dq + dh, 2·L − 1) and ``qkv_bn`` a
    plain BatchNorm."""
    L, C = 24, 16
    block, variables = _random_block(
        tmisc.GatedAxialAttention(L, C, dtype=torch.bfloat16), 21)
    params = variables["params"]
    assert set(params) == {"to_qkv", "qkv_bn", "relative", "to_out",
                           "gate_qr", "gate_kr", "gate_v", "gate_rv"}
    assert params["relative"].shape == (10, 2 * L - 1)
    assert params["gate_qr"].shape == () and \
        params["to_qkv"]["kernel"].shape == (C, 8 * 10)
    assert set(variables["batch_stats"]["qkv_bn"]) == {"mean", "var"}
    x = np.random.RandomState(22).standard_normal((6, L, C))
    x = (8 * x).astype(np.float32)
    jblock = jmisc.GatedAxialAttention(L, C, dtype=jnp.bfloat16)
    want = np.asarray(_jax_forward(jblock, variables, x)).astype(np.float32)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (6, L, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL * float(np.abs(want).max()))


def test_medt_block_train_step_matches_jax():
    """A stride-2 ``MedTAxialBlock`` (gated, 12 → 16 channels on a 2×10×10
    map) in train mode: the output and every moved running statistic, the
    attentions' ``qkv_bn`` (over (b, L)) included, against JAX."""
    block, variables = _random_block(
        tmisc.MedTAxialBlock(12, 16, 10, strides=2), 23)
    block.train()
    x = np.random.RandomState(24).standard_normal((2, 10, 10, 12))
    x = x.astype(np.float32)
    want, moved = _jax_forward(jmisc.MedTAxialBlock(16, 5, strides=2),
                               variables, x, train=True,
                               mutable=["batch_stats"])
    with torch.no_grad():
        got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 5, 5, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SMALL_TOL * float(np.abs(want).max()))
    stats = torch_to_flax(block)["batch_stats"]
    assert set(stats["height"]["qkv_bn"]) == {"mean", "var"}
    for path, w in jax.tree_util.tree_leaves_with_path(
            moved["batch_stats"]):
        g = stats
        for p in path:
            g = g[p.key]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=SMALL_TOL * float(np.abs(w).max()))


def test_medt_refuses_a_map_its_tables_were_not_built_for():
    """Built for 1024² (the default), ``gated`` and ``medt`` refuse a 64²
    input, naming ``input_size``; ``axialattwopo_unet`` has no table and
    takes any size."""
    x = torch.zeros(1, 3, 64, 64)
    for name in ("gated", "medt"):
        model = tzoo.get_model(name, {}, training=False, device="cpu")
        with pytest.raises(ValueError, match="input_size"):
            with torch.no_grad():
                model(x)
    model = tzoo.get_model("axialattwopo_unet", {"base": 8},
                           training=False, device="cpu")
    with torch.no_grad():
        assert model(x).shape == (1, 1, 64, 64)
