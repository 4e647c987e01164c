"""Port parity: decoder blocks and the whole flagship against the JAX package.

The JAX flagship is built once per process (its variables from
``jax.eval_shape`` filled from a numpy seed, so nothing is compiled for the
init) and converted into the port with ``convert.load_flax``. fp32
tolerances: 1e-5 for one block, 1e-4 for the whole network (about 80 layers of
reassociated sums), as the torch oracles of tests/test_flagship_torch_oracle.py.

The ``pallas_tail`` routes run on the CPU through the plain versions of the
decode-node kernels (the JAX package through its Pallas kernels in interpret
mode): 1e-5 against the port's own logical block, 2e-4 against JAX, as
tests/test_packed_tail.py and tests/test_pallas_decode_pair.py hold JAX's own
routes to its logical path.
"""

import functools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.models.decoders import DecoderBlock as JDecoderBlock
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import flax_to_torch, load_flax
from eyediseasesegmentation_tpu_torch.models.decoders import DecoderBlock
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    SCSEAttention, upsample2x, upsample2x_w)

from test_torch_axial import flax_variables, random_flax_variables

BASE_DIM = 2              # input 32·base_dim = 64², full widths
MODEL_PARAMS = {"encoder_name": "BoTSER50_Axial_Imagenet_3",
                "decoder_attention_type": "scse", "base_dim": BASE_DIM,
                "classes": 1, "drop_block_prob": 0.0,
                "fast_inference": False}


@functools.lru_cache(maxsize=None)
def jax_flagship():
    """(JAX model, its variables as numpy, jitted apply) — built once."""
    model = jzoo.get_model("unetplusplusstar", MODEL_PARAMS, training=False,
                           dtype=jnp.float32)
    size = 32 * BASE_DIM
    shapes = jax.eval_shape(partial(model.init, train=False),
                            {"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, size, size, 3), jnp.float32))
    variables = random_flax_variables(shapes, seed=2024)
    return model, variables, jax.jit(partial(model.apply, train=False))


def torch_flagship(dtype=torch.float32, **params):
    _, variables, _ = jax_flagship()
    model = tzoo.get_model("unetplusplusstar", {**MODEL_PARAMS, **params},
                           training=False, dtype=dtype, device="cpu")
    return load_flax(model, variables)


def test_flagship_matches_jax():
    _, variables, apply = jax_flagship()
    size = 32 * BASE_DIM
    x = np.random.RandomState(0).uniform(-1, 1, (2, size, size, 3))
    x = x.astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_flagship()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_flagship_heads_match_jax():
    """Deep supervision and the classification head (kept with
    ``training=True``; the forward itself is the eval one)."""
    params = {**MODEL_PARAMS, "deep_supervision": True, "clf_head": True}
    size = 32 * BASE_DIM
    jm = jzoo.get_model("unetplusplusstar", params, dtype=jnp.float32)
    x = np.random.RandomState(5).uniform(-1, 1, (1, size, size, 3))
    x = x.astype(np.float32)
    variables = flax_variables(jm, 11, jnp.asarray(x))
    mask, ds, clf = jax.jit(partial(jm.apply, train=False))(variables,
                                                             jnp.asarray(x))
    tm = load_flax(tzoo.get_model("unetplusplusstar", params, device="cpu"),
                   variables)
    with torch.no_grad():
        t_mask, t_ds, t_clf = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(t_ds) == len(ds) == 3
    for got, want in zip([t_mask, *t_ds], [mask, *ds]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_clf.numpy(), np.asarray(clf),
                               rtol=1e-4, atol=1e-4)


def test_converter_sets_every_parameter_and_buffer():
    _, variables, _ = jax_flagship()
    n_leaves = sum(len(jax.tree_util.tree_leaves(variables[c]))
                   for c in ("params", "batch_stats"))
    state = flax_to_torch(variables)
    model = tzoo.get_model("unetplusplusstar", MODEL_PARAMS, training=False,
                           device="cpu")
    want = model.state_dict()
    assert len(state) == n_leaves
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)


def test_converter_rejects_unknown_and_missing_leaves():
    model = DecoderBlock(8, 8, 8, attention_type="scse")
    jm = JDecoderBlock(8, 8, 8, attention_type="scse", drop_block_prob=0.0)
    x, s = jnp.zeros((1, 4, 4, 8)), jnp.zeros((1, 8, 8, 8))
    variables = flax_variables(jm, 0, x, s)
    load_flax(model, variables)
    bad = {"params": {**variables["params"], "Mystery_0": {"w": np.ones(2)}},
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        flax_to_torch(bad)
    short = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    del short["params"]["conv2"]
    with pytest.raises(ValueError):
        load_flax(model, short)


@pytest.mark.parametrize("use_catt", [True, False], ids=["catt", "scse"])
def test_decoder_block_matches_jax(use_catt):
    rng = np.random.RandomState(1)
    cin, cout, base_dim = 32, 16, 8
    x = rng.randn(2, base_dim, base_dim, cin).astype(np.float32)
    if use_catt:
        skip_ch = 128       # C/16 = 8 channels, 2 per head for the gate
        skips = [rng.randn(2, 2 * base_dim, 2 * base_dim, skip_ch)
                 .astype(np.float32)]
    else:
        skip_ch = 24
        skips = [rng.randn(2, 2 * base_dim, 2 * base_dim, c)
                 .astype(np.float32) for c in (16, 8)]
    jm = JDecoderBlock(cin, skip_ch, cout, base_dim=base_dim, level=0,
                       use_catt=use_catt, attention_type="scse",
                       drop_block_prob=0.0, dtype=jnp.float32)
    jx, js = jnp.asarray(x), [jnp.asarray(s) for s in skips]
    variables = flax_variables(jm, 3, jx, js)
    want = np.asarray(jm.apply(variables, jx, js, train=False))
    tm = load_flax(DecoderBlock(cin, skip_ch, cout, base_dim=base_dim,
                                level=0, use_catt=use_catt,
                                attention_type="scse"), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 [torch.from_numpy(s).permute(0, 3, 1, 2) for s in skips])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_get_model_rejects_what_is_not_ported():
    with pytest.raises(KeyError, match="Cannot find"):
        tzoo.get_model("hrnet64", {}, device="cpu")
    with pytest.raises(KeyError, match="Unknown encoder"):
        tzoo.get_model("unetplusplusstar",
                       {"encoder_name": "vgg"}, device="cpu")
    with pytest.raises(ValueError, match="pallas_tail"):
        tzoo.get_model("unetplusplusstar", {**MODEL_PARAMS,
                                            "pallas_tail": "triple"},
                       device="cpu")


def test_get_model_builds_on_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        model = tzoo.get_model("unetplusplusstar", MODEL_PARAMS)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tzoo.get_model("unetplusplusstar", MODEL_PARAMS)
    model = tzoo.get_model("unetplusplusstar", MODEL_PARAMS, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


# ---------------------------------------------------------------------------
# pallas_tail: the fused decode-node routes
# ---------------------------------------------------------------------------

TAILS = [True, "pair", "pair_up"]
TAIL_IDS = ["v1", "pair", "pair_up"]


def _nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("tail", TAILS, ids=TAIL_IDS)
@pytest.mark.parametrize("cout,attention", [(12, "scse"), (64, "scse"),
                                            (16, None)])
def test_decoder_block_pallas_tail_matches_jax(cout, attention, tail):
    """The shapes of tests/test_packed_tail.py's pallas block tests."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 8, 24).astype(np.float32)
    skips = [rng.randn(2, 16, 16, c).astype(np.float32) for c in (6, 10)]
    kw = dict(in_channels=24, skip_channels=16, out_channels=cout,
              attention_type=attention)
    jm = JDecoderBlock(fast_tail=True, pallas_tail=tail, drop_block_prob=0.1,
                       dtype=jnp.float32, **kw)
    jx, js = jnp.asarray(x), [jnp.asarray(s) for s in skips]
    variables = flax_variables(JDecoderBlock(drop_block_prob=0.1, **kw), 5,
                               jx, js)
    want = np.asarray(jm.apply(variables, jx, js, train=False))
    logical = load_flax(DecoderBlock(**kw), variables)
    routed = load_flax(DecoderBlock(pallas_tail=tail, **kw), variables)
    tx, ts = _nchw(x), [_nchw(s) for s in skips]
    with torch.no_grad():
        got = routed(tx, ts)
        plain = logical(tx, ts)
        unrouted = routed(tx, ts, kernel_route=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(unrouted.numpy(), plain.numpy(), rtol=0,
                               atol=0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("tail", TAILS + ["v1"], ids=TAIL_IDS + ["v1_name"])
def test_flagship_pallas_tail_matches_jax(tail):
    """64² flagship with fast_min_res=32, so that tail nodes qualify,
    against the cached JAX logical flagship."""
    _, variables, apply = jax_flagship()
    size = 32 * BASE_DIM
    x = np.random.RandomState(3).uniform(-1, 1, (1, size, size, 3))
    x = x.astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    model = torch_flagship(pallas_tail=tail, fast_min_res=32)
    feat_hw = [(size >> s, size >> s) for s in (5, 4, 3, 2, 1)]
    assert model.decoder.kernel_nodes(feat_hw) == ["x_3_3", "x_2_3", "x_1_3"]
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("fast_min_res,want", [
    (512, ["x_3_3", "x_2_3", "x_1_3"]),
    (256, ["x_3_3", "x_2_3", "x_0_2", "x_1_3"]),
    (2048, []),
])
def test_kernel_route_nodes_at_1024(fast_min_res, want):
    """Which nodes take the kernel route for a 1024² input: shape
    arithmetic only. x_0_3 (handed on packed in the JAX decoder) and x_0_4
    (no skip) stay on the logical path, as do the cross-axial nodes and the
    nodes with 128 or more output channels."""
    model = tzoo.get_model(
        "unetplusplusstar",
        {**MODEL_PARAMS, "pallas_tail": "pair", "fast_min_res": fast_min_res},
        training=False, device="cpu")
    feat_hw = [(1024 >> s, 1024 >> s) for s in (5, 4, 3, 2, 1)]
    assert model.decoder.kernel_nodes(feat_hw) == want
    off = tzoo.get_model("unetplusplusstar",
                         {**MODEL_PARAMS, "fast_min_res": fast_min_res},
                         training=False, device="cpu")
    assert off.decoder.kernel_nodes(feat_hw) == []


@pytest.mark.parametrize("tail", TAILS, ids=TAIL_IDS)
def test_pallas_tail_adds_no_parameters(tail):
    base = tzoo.get_model("unetplusplusstar", MODEL_PARAMS, training=False,
                          device="cpu").state_dict()
    routed = tzoo.get_model("unetplusplusstar",
                            {**MODEL_PARAMS, "pallas_tail": tail},
                            training=False, device="cpu").state_dict()
    assert list(routed) == list(base)
    assert all(routed[k].shape == base[k].shape for k in base)


def test_pallas_tail_block_raises_in_training_mode():
    """In training a pallas_tail block takes the plain path (the kernels
    have no backward); forced onto the kernel route under grad mode, the
    kernel's wrapper raises instead of cutting the graph."""
    block = DecoderBlock(8, 8, 8, attention_type="scse", pallas_tail="pair",
                         drop_block_prob=0.0)
    plain = DecoderBlock(8, 8, 8, attention_type="scse",
                         drop_block_prob=0.0)
    plain.load_state_dict(block.state_dict())
    block.train()
    plain.train()
    x, skip = torch.randn(1, 8, 4, 4), [torch.randn(1, 8, 8, 8)]
    y = block(x, skip)
    assert y.grad_fn is not None
    np.testing.assert_array_equal(y.detach().numpy(),
                                  plain(x, skip).detach().numpy())
    with pytest.raises(RuntimeError, match="no backward"):
        block._pallas_pair_call(x, skip)


def test_scse_raw_gates_and_mean_override_match_jax():
    from eyediseasesegmentation_tpu.models.modules.layers import (
        SCSEAttention as JSCSE)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5, 20).astype(np.float32)       # pre-upsample part 0
    skip = rng.randn(2, 12, 10, 12).astype(np.float32)
    jparts = [jnp.asarray(x), jnp.asarray(skip)]
    plain = JSCSE(dtype=jnp.float32)
    shapes = jax.eval_shape(plain.init, jax.random.PRNGKey(0),
                            [jnp.zeros((2, 12, 10, 20)), jparts[1]])
    variables = random_flax_variables(shapes, seed=4)
    tm = load_flax(SCSEAttention(32), variables)
    gc, wk, wb = JSCSE(raw_gates=True, up_part0=True, dtype=jnp.float32).apply(
        variables, jparts)
    with torch.no_grad():
        t_gc, t_wk, t_wb = tm.raw_gates([_nchw(x), _nchw(skip)],
                                        up_part0=True)
    assert t_gc.dtype == torch.float32 and tuple(t_gc.shape) == (2, 32)
    np.testing.assert_allclose(t_gc.numpy(), np.asarray(gc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_wk.detach().numpy(), np.asarray(wk),
                               rtol=0, atol=0)
    np.testing.assert_allclose(float(t_wb.detach()), float(wb), rtol=0, atol=0)

    y = rng.randn(2, 12, 10, 32).astype(np.float32)
    means = rng.randn(2, 32).astype(np.float32)
    want = plain.apply(variables, jnp.asarray(y),
                       mean_override=jnp.asarray(means))
    with torch.no_grad():
        got = tm(_nchw(y), mean_override=torch.from_numpy(means))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_upsample2x_w_matches_jax():
    from eyediseasesegmentation_tpu.models.modules.layers import (
        upsample2x_w as j_upsample2x_w)
    x = np.random.RandomState(9).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(j_upsample2x_w(jnp.asarray(x)))
    got = upsample2x_w(_nchw(x))
    assert tuple(got.shape) == (2, 3, 5, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    # W then H is the full bilinear ×2 up to one more rounding
    from eyediseasesegmentation_tpu_torch.ops.decode_pair import upsample2x_h
    np.testing.assert_allclose(upsample2x_h(got).numpy(),
                               upsample2x(_nchw(x)).numpy(), rtol=0,
                               atol=1e-6)


def test_training_raises():
    """What training still refuses: a model left in eval mode under grad
    mode (its K1 wrapper raises rather than return a tensor without a
    gradient). The train forward itself is differentiable."""
    model = torch_flagship()
    x = torch.zeros(1, 3, 32 * BASE_DIM, 32 * BASE_DIM)
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)
    model.train()
    assert model(x).grad_fn is not None
