"""Port parity: UNet 3+ and smp's Linknet / PSPNet / DeepLabV3 / PAN /
MAnet against the JAX package, and every name this slice adds to the port's
registry (``test_torch_zoo_encoders.py`` holds the new encoders).

Each family runs once in fp32 on both sides with the same weights: the
port's, drawn by ``init_random`` (BatchNorm statistics away from the
identity) and carried to JAX by ``convert.torch_to_flax``; logits within
1e-4 × max|logit|. The JAX program must read every leaf and flax must find
every variable it declares, at its shape, so the two trees are one. PSPNet
and PAN run at 256², where PSP's 3-grid pools to 4×4 and PAN's FPA pyramid
has the even kernels 4 and 2 (at 64² it has one 1×1 level); the rest at
64². Small cases pin flax's SAME padding (asymmetric for a stride-2 conv on
an even map and for an even kernel) and its unflipped transposed conv.
Every new registered name builds and forwards in the port, and its weights
cross ``torch_to_flax`` and ``load_flax`` unchanged.
"""

from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import (flax_to_torch,
                                                      load_flax,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.models.modules import layers
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    conv2d_same)
from eyediseasesegmentation_tpu_torch.models.smp_extra import _TransposeX2
from test_torch_zoo import PORTED_EXTRA, _bit_equal, _flat

TOL = 1e-4                       # × max|logit|, fp32, the whole network
SMALL_3PLUS = {"filters": [8, 16, 32, 64, 128], "cat_channels": 8}

# (registry name, model params, input side)
FAMILIES = {
    "unet3plus": ("Unet3Plus_Base", SMALL_3PLUS, 64),
    "linknet_resnet18": ("Linknet", {"encoder_name": "resnet18"}, 64),
    "deeplabv3_resnet18": ("DeepLabV3", {"encoder_name": "resnet18"}, 64),
    "manet_resnet18": ("MAnet", {"encoder_name": "resnet18"}, 64),
    "pspnet_resnet18_256": ("PSPNet", {"encoder_name": "resnet18"}, 256),
    "pan_resnet18_256": ("PAN", {"encoder_name": "resnet18",
                                 "input_size": 256}, 256),
}


def _input(size, seed=1):
    x = np.random.RandomState(seed).uniform(-1, 1, (1, size, size, 3))
    return x.astype(np.float32)


# XLA's CPU backend at its lowest optimisation: these graphs run once, and
# it halves their compile time
QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _port_variables(name, params, training=False, seed=11):
    """The port's model with weights drawn by ``init_random`` (BatchNorm
    statistics away from the identity) and its flax variables."""
    model = tzoo.get_model(name, params, training=training, device="cpu")
    tzoo.init_random(model, torch.Generator().manual_seed(seed))
    return model, torch_to_flax(model)


def _jax_forward(jmodel, variables, x, **kwargs):
    """``jmodel.apply`` on the port's variables, jitted. flax raises on a
    variable the model declares and the tree lacks, and on one of another
    shape; a leaf of the tree the model never reads is an unused input of
    the traced program, and fails here. So the trees are equal."""
    traced = jax.jit(partial(jmodel.apply, **kwargs)).trace(variables, x)
    jaxpr = traced.jaxpr.jaxpr
    read = {id(v) for eqn in jaxpr.eqns for v in eqn.invars}
    read |= {id(v) for v in jaxpr.outvars}
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(variables)]
    unused = [p for p, v in zip(paths, jaxpr.invars) if id(v) not in read]
    assert len(paths) + 1 == len(jaxpr.invars) and not unused, unused[:10]
    return traced.lower().compile(QUICK_COMPILE)(variables, x)


def _hold(got, want, tag):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= TOL * scale, (tag, err, scale)


def check_family(name, params, size):
    """The eval forward of registry ``name`` against JAX in fp32 on the
    same weights, and the weights across ``convert`` both ways, bit for
    bit."""
    x = _input(size)
    tmodel, variables = _port_variables(name, params)
    jmodel = jzoo.get_model(name, params, training=False, dtype=jnp.float32)
    want = _flat(_jax_forward(jmodel, variables, jnp.asarray(x),
                              train=False))
    with torch.no_grad():
        got = _flat(tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)))
    _hold(got, want, name)
    state = tmodel.state_dict()
    back = flax_to_torch(variables)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], v) for k, v in state.items())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    check_family(*FAMILIES[family])


def test_unet3plus_deep_supervision_train_matches_jax():
    """``Unet3Plus_DS`` in train mode (batch statistics): ``(d1, [4 heads
    at the input's size])`` and the moved running statistics, against
    JAX."""
    x = _input(64, seed=2)
    tmodel, variables = _port_variables("Unet3Plus_DS", SMALL_3PLUS,
                                        training=True, seed=12)
    jmodel = jzoo.get_model("Unet3Plus_DS", SMALL_3PLUS, training=True,
                            dtype=jnp.float32)
    out, moved = _jax_forward(jmodel, variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    want = _flat(out)
    tmodel.train()
    with torch.no_grad():
        got = _flat(tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == 5 and all(g.shape == (1, 64, 64, 1) for g in got)
    _hold(got, want, "Unet3Plus_DS train")
    stats = torch_to_flax(tmodel)["batch_stats"]
    for path, w in jax.tree_util.tree_leaves_with_path(
            moved["batch_stats"]):
        g = stats
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,side", [
    (3, 2, 8), (5, 2, 8), (3, 2, 7), (4, 1, 4), (2, 1, 5)])
def test_same_padding_matches_flax(kernel, stride, side):
    """``conv2d_same`` against flax's ``padding="SAME"``: (0, 1) for a 3×3
    stride 2 on an even map, (1, 2) for a 5×5, (1, 2) / (0, 1) for the even
    kernels 4 and 2; a symmetric pad would be off by the border's terms."""
    rng = np.random.default_rng(kernel * 10 + side)
    x = rng.standard_normal((1, side, side, 3), dtype=np.float32)
    k = rng.standard_normal((kernel, kernel, 3, 4), dtype=np.float32)
    conv = nn.Conv(4, (kernel, kernel), strides=(stride, stride),
                   padding="SAME", use_bias=False)
    want = np.asarray(conv.apply({"params": {"kernel": k}}, x))
    tconv = torch.nn.Conv2d(3, 4, kernel, bias=False)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        got = conv2d_same(torch.from_numpy(x).permute(0, 3, 1, 2), tconv,
                          torch.float32, stride).permute(0, 2, 3, 1).numpy()
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       tconv.weight, None, stride, kernel // 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kernel % 2 == 0 or side % 2 == 0:
        sym = sym[..., :want.shape[1], :want.shape[2]]
        assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_dropout_matches_flax_at_its_draw():
    """flax's ``nn.Dropout`` keep mask, drawn from its key, given to the
    port's ``dropout``: the same kept elements and scaling (PSPNet's
    dropout in train mode). The port's ``Dropout`` is the identity in
    eval."""
    x = np.random.RandomState(4).randn(2, 6, 5, 8).astype(np.float32)
    mod = nn.Dropout(0.2, deterministic=False)
    key = jax.random.PRNGKey(3)
    drawn = {}
    real = jax.random.bernoulli

    def spy(k, p, shape):
        drawn["keep"] = np.asarray(real(k, p, shape))
        return real(k, p, shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", spy)
        want = np.asarray(mod.apply({}, jnp.asarray(x),
                                    rngs={"dropout": key}))
    got = layers.dropout(torch.from_numpy(x),
                         torch.from_numpy(drawn["keep"].copy()), 0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    module = layers.Dropout(0.2)
    xt = torch.from_numpy(x)
    assert torch.equal(module(xt), xt)
    module.train()
    module.generator = torch.Generator().manual_seed(0)
    kept = (module(xt) != 0).float().mean().item()
    assert 0.7 < kept < 0.9


def test_transposed_conv_matches_flax_through_convert():
    """flax's ``ConvTranspose`` (4×4, stride 2, SAME) does not flip its
    kernel: ``convert`` flips it into the port's ``_TransposeX2`` and back.
    Without the flip the result is off."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 5, 3), dtype=np.float32)
    k = rng.standard_normal((4, 4, 3, 4), dtype=np.float32)
    conv = nn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME",
                            use_bias=False)
    want = np.asarray(conv.apply({"params": {"kernel": k}}, x))
    variables = {"params": {"ConvTranspose_0": {"kernel": k},
                            "BatchNorm_0": {"scale": np.ones(4, np.float32),
                                            "bias": np.zeros(4, np.float32)}},
                 "batch_stats": {"BatchNorm_0": {
                     "mean": np.zeros(4, np.float32),
                     "var": np.full(4, 1.0 - 1e-5, np.float32)}}}
    block = load_flax(_TransposeX2(3, 4), variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(xt).permute(0, 2, 3, 1).numpy()
        unflipped = F.conv_transpose2d(
            xt, torch.from_numpy(k.transpose(2, 3, 0, 1).copy()), None, 2, 1)
    assert got.shape == want.shape == (1, 12, 10, 4)
    np.testing.assert_allclose(got, np.maximum(want, 0), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-1
    _bit_equal(torch_to_flax(block), variables)


@pytest.mark.parametrize("channels_last", [False, True])
def test_resize_to_splits_an_output_past_the_index_limit(monkeypatch,
                                                         channels_last):
    """Past ``RESIZE_OUT_LIMIT`` output elements ``resize_to`` resizes per
    sample and channel block; the result equals one ``F.interpolate``."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 5, 4, 6), dtype=np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    want = F.interpolate(x, size=(9, 13), mode="bilinear",
                         align_corners=False)
    monkeypatch.setattr(layers, "RESIZE_OUT_LIMIT", 2 * 9 * 13 + 1)
    got = layers.resize_to(x, (9, 13))
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == \
        channels_last


def check_registered(name):
    """Registry ``name`` at its widths, with the inference demotions, on the
    CPU: finite fp32 logits at 64², and its weights across
    ``torch_to_flax`` and ``load_flax`` unchanged. A model whose parameters
    depend on the input size (PAN, Swin, the TransUNets) is built for 64²;
    the others have no ``input_size`` and the registry drops it."""
    params = {"input_size": 64}
    model = tzoo.get_model(name, params, training=False, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 1, 64, 64) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    state = {k: v.clone() for k, v in model.state_dict().items()}
    load_flax(model, torch_to_flax(state))
    loaded = model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in state.items())


# the names on EfficientNet-b4, which no family case covers:
# test_torch_zoo_encoders.py builds them
ON_B4 = ("b4_unet32", "b4_effunet32")


@pytest.mark.parametrize("name", [n for n in PORTED_EXTRA
                                  if n not in ON_B4])
def test_registered_name_builds_and_round_trips(name):
    check_registered(name)


def test_pan_refuses_a_map_its_pyramid_was_not_built_for():
    model = tzoo.get_model("PAN", {"encoder_name": "resnet18"},
                           training=False, device="cpu")
    assert model.fpa.kernels == (7, 5, 3)
    with pytest.raises(ValueError, match="input_size"):
        with torch.no_grad():
            model(torch.zeros(1, 3, 256, 256))
