"""Port parity: the train-mode modules against the JAX package.

Each module runs ``.train()`` in the port and
``apply(..., train=True, mutable=["batch_stats"])`` in JAX on the same
weights (numpy-seeded, converted with ``convert.load_flax``) and inputs:
outputs, the gradients of ⟨output, r⟩ for a fixed random r (with respect to
the input and every parameter), and the updated running statistics, at
1e-5 of each leaf's max (2e-5 for the decoder block, a few more layers).
The conv BatchNorm's running variance moves by the biased batch variance,
the axial norms' by the unbiased one; the tests pin each. DropBlock runs at
the Bernoulli draw the JAX key makes. Last, the guard: each of the four
kernel wrappers raises when an input requires grad under grad mode.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.models.decoders import DecoderBlock as JDB
from eyediseasesegmentation_tpu.models.encoders import Bottleneck as JBot
from eyediseasesegmentation_tpu.models.modules import axial as JA
from eyediseasesegmentation_tpu.models.modules import layers as JL
from eyediseasesegmentation_tpu_torch.convert import load_flax, torch_to_flax
from eyediseasesegmentation_tpu_torch.models.decoders import DecoderBlock
from eyediseasesegmentation_tpu_torch.models.encoders import Bottleneck
from eyediseasesegmentation_tpu_torch.models.modules import axial as TA
from eyediseasesegmentation_tpu_torch.models.modules import layers as TL
from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK
from eyediseasesegmentation_tpu_torch.ops import conv as CK
from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

from test_torch_axial import random_flax_variables

TOL = 1e-5
# parameters whose exact gradient is zero in these modules, by invariance:
# an attention norm's bias shifts every logit of a row alike (softmax is
# shift-invariant); v's norm bias adds a constant to ``attn · v`` (rows of
# attn sum to one) and its scale a per-channel factor, both of which the
# out norm's batch statistics remove (but for its eps); a conv bias right
# before a train-mode BatchNorm is removed by the batch mean. Their fp32
# gradients are rounding noise of the module's other gradients, so they
# are held to TOL of the largest gradient of the module.
INVARIANT = ("attention_norm_bias", "to_v_bn_bias", "to_v_bn_scale",
             "init_conv/bias", "h_catt/out_norm_bias")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    top = np.abs(np.asarray(want)).max()
    assert err <= tol * top + 1e-12, (what, err, top)


def run_both(jmod, tmod, inputs, layout, seed, tol=TOL, **call):
    """Run ``jmod`` (train) and ``tmod`` (``.train()``) on the same inputs
    and weights; hold outputs, input and parameter gradients of ⟨out, r⟩
    and the new batch_stats. ``layout``: 'nhwc' (maps, NCHW in the port)
    or 'seq' ((b, L, C) on both sides). Returns both new batch_stats."""
    jin = [jnp.asarray(a) for a in inputs]
    shapes = jax.eval_shape(partial(jmod.init, train=False, **call),
                            jax.random.PRNGKey(0), *jin)
    variables = random_flax_variables(shapes, seed)
    load_flax(tmod, variables)
    conv = (lambda a: _nchw(a)) if layout == "nhwc" else torch.from_numpy
    back = _nhwc if layout == "nhwc" else (lambda t: t.detach().numpy())
    out_shape = jax.eval_shape(
        lambda v, *x: jmod.apply(v, *x, train=True, mutable=["batch_stats"],
                                 **call)[0], variables, *jin)
    r = np.random.RandomState(seed + 1).randn(*out_shape.shape).astype(
        np.float32)

    def loss(params, *x):
        out, upd = jmod.apply({**variables, "params": params}, *x,
                              train=True, mutable=["batch_stats"], **call)
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (want, want_stats)), (gp, *gx) = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(jin) + 1)), has_aux=True))(
            variables["params"], *jin)
    tmod.train()
    tin = [conv(a).requires_grad_(True) for a in inputs]
    got = tmod(*tin)
    rt = _nchw(r) if layout == "nhwc" else torch.from_numpy(r)
    (got * rt).sum().backward()
    _close(back(got), want, tol, "output")
    for t, g in zip(tin, gx):
        _close(back(t.grad), g, tol, "input grad")
    grads = torch_to_flax({n: p.grad for n, p in tmod.named_parameters()})
    top = max(np.abs(g).max() for _, g in _leaves(gp))
    for path, g in _leaves(gp):
        name = "/".join(path)
        got_g = _get(grads["params"], path)
        if any(name.endswith(k) for k in INVARIANT):
            assert np.abs(got_g - g).max() <= tol * top, (name, top)
        else:
            _close(got_g, g, tol, name)
    got_stats = torch_to_flax(tmod)["batch_stats"]
    for path, w in _leaves(want_stats):
        _close(_get(got_stats, path), w, tol, "/".join(path))
    return got_stats, jax.tree_util.tree_map(np.asarray, want_stats), \
        variables


def test_batchnorm_train_matches_jax():
    x = np.random.RandomState(0).randn(2, 5, 6, 8).astype(np.float32) + 0.7
    new, want, variables = run_both(JL.BatchNorm(), TL.BatchNorm(8), [x],
                                    "nhwc", seed=3)
    # the biased batch variance, pinned
    m, v = x.mean((0, 1, 2)), x.var((0, 1, 2))
    np.testing.assert_allclose(new["var"], 0.9 * variables["batch_stats"][
        "var"] + 0.1 * v, rtol=1e-5)
    np.testing.assert_allclose(new["mean"], 0.9 * variables["batch_stats"][
        "mean"] + 0.1 * m, rtol=1e-5, atol=1e-7)


def test_frozen_batchnorm_train_matches_jax():
    x = np.random.RandomState(1).randn(2, 5, 6, 8).astype(np.float32)
    new, want, variables = run_both(JL.BatchNorm(frozen=True),
                                    TL.BatchNorm(8, frozen=True), [x],
                                    "nhwc", seed=4)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(new[k], variables["batch_stats"][k])


def test_axial_attention_train_matches_jax():
    x = np.random.RandomState(2).randn(6, 8, 32).astype(np.float32)
    new, _, variables = run_both(JA.AxialAttention(8, 32, heads=4),
                                 TA.AxialAttention(8, 32, heads=4), [x],
                                 "seq", seed=5)
    # the qkv norm's running variance moved by the UNBIASED variance
    tm = TA.AxialAttention(8, 32, heads=4)
    load_flax(tm, variables)
    qkv = torch.from_numpy(x) @ tm.to_qkv.detach()
    n = qkv.shape[0] * qkv.shape[1]
    var = qkv.reshape(n, -1).var(0, unbiased=True).numpy()
    np.testing.assert_allclose(
        new["to_qkv_bn_var"],
        0.9 * variables["batch_stats"]["to_qkv_bn_var"] + 0.1 * var,
        rtol=1e-5)


def test_cross_axial_attention_train_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 24).astype(np.float32)
    skip = rng.randn(4, 8, 16).astype(np.float32)
    run_both(JA.CrossAxialAttention(8, 24, 16, heads=4),
             TA.CrossAxialAttention(8, 24, 16, heads=4), [x, skip], "seq",
             seed=6)


def test_bottleneck_frozen_bn_train_matches_jax():
    x = np.random.RandomState(4).randn(2, 8, 8, 32).astype(np.float32)
    new, _, variables = run_both(
        JBot(16, strides=2, use_se=True, frozen_bn=True, out_features=64),
        Bottleneck(32, 16, strides=2, frozen_bn=True), [x], "nhwc", seed=7)
    for path, v in _leaves(variables["batch_stats"]):
        np.testing.assert_array_equal(_get(new, path), v)


def test_decoder_block_cross_gate_train_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    skip = rng.randn(2, 8, 8, 64).astype(np.float32)
    run_both(JDB(16, 64, 12, base_dim=4, level=0, use_catt=True,
                 attention_type="scse", drop_block_prob=0.0),
             DecoderBlock(16, 64, 12, base_dim=4, level=0, use_catt=True,
                          attention_type="scse", drop_block_prob=0.0),
             [x, skip], "nhwc", seed=8, tol=2e-5)


@pytest.mark.parametrize("hw", [(12, 10), (5, 4)])
def test_dropblock_matches_jax_at_its_draw(hw):
    """The JAX DropBlock's Bernoulli centres, drawn from its key, given to
    the port's ``drop_block``: the same kept blocks and renormalisation
    (the block clipped to a small map in the second case)."""
    h, w = hw
    x = np.random.RandomState(6).randn(2, h, w, 5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    mod = JL.DropBlock2d(0.3, block_size=7)
    want = mod.apply({}, jnp.asarray(x), train=True, rngs={"dropout": key})
    # the key DropBlock draws from: make_rng('dropout') in its scope
    drawn = {}
    real = jax.random.bernoulli

    def spy(k, p, shape):
        drawn["c"] = np.asarray(real(k, p, shape))
        drawn["p"] = float(p)
        return real(k, p, shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", spy)
        mod.apply({}, jnp.asarray(x), train=True, rngs={"dropout": key})
    assert drawn["p"] == pytest.approx(
        TL.dropblock_gamma(0.3, h, w, 7), rel=1e-6)
    centres = _nchw(drawn["c"].astype(np.float32))
    got = TL.drop_block(_nchw(x), centres, 7)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    block = TL.DropBlock2d(0.3)
    assert torch.equal(block(_nchw(x)), _nchw(x))       # eval: identity


def test_kernel_wrappers_refuse_autograd():
    """K1-K4's wrappers raise on an input that requires grad under grad
    mode (the kernels have no backward), before any library is loaded;
    under no_grad they run (here their plain versions)."""
    rng = np.random.RandomState(7)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    parts = [t(1, 8, 6, 6), t(1, 8, 6, 6)]
    gate = (torch.sigmoid(t(1, 16)), t(16), t(1)[0])
    k1, k2 = t(8, 16, 3, 3), t(8, 8, 3, 3)
    aff = (t(8).abs(), t(8))
    x = t(4, 8, 16)
    attn = [x, x, t(16, 4 * 20), None, (t(80).abs(), t(80)), None,
            t(8, 8, 8), t(8, 8, 8), t(4, 8, 8), (t(12).abs(), t(12)),
            (t(32).abs(), t(32))]
    calls = {
        "axial_attention": lambda: AK.axial_attention(
            *attn, heads=4, dkq=8, dv=4, dtype=torch.float32),
        "conv3x3_bn_relu": lambda: CK.conv3x3_bn_relu(parts[0], k2, *aff),
        "scse_conv3x3_bn_relu": lambda: SK.scse_conv3x3_bn_relu(
            parts, *gate, k1, *aff),
        "scse_conv3x3_pair": lambda: PK.scse_conv3x3_pair(
            parts, *gate, k1, *aff, k2, *aff),
    }
    for name, call in calls.items():
        with torch.no_grad():
            call()
        for arg in (parts[1], k2, attn[2]):
            arg.requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call()
        for arg in (parts[1], k2, attn[2]):
            arg.requires_grad_(False)
