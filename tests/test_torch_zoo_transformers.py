"""Port parity: the transformer families (the Swin attention U-Net,
SwinformerStar, SegFormerStar, TransUNet R50 / B16, TransUnet_V2) against
the JAX package at 64² in fp32, as ``test_torch_zoo_extra.check_family``
holds them: the port's weights drawn by ``init_random`` and carried to JAX
by ``convert.torch_to_flax``, one variable tree, every output within 1e-4 ×
max|output|.

At 64² every size-dependent path runs: Swin's stages 0-1 pad their maps to
window multiples and shift, stage 2 shrinks the window to 4² and stage 3 to
2² (its ``rel_bias`` tables (49, ·) and (9, ·)); the TransUNet-R50 trunk's
pool leaves a 15² map whose skip is padded to 16²; the ViTs' ``pos_embed``
has 16 rows, so these models are built with ``input_size`` 64. Small cases
hold a shifted, padded ``SwinBlock``, weight standardisation and a
``PreActBottleneck`` (GroupNorm) to 1e-5, and pin tanh-GELU and flax's 1e-6
LayerNorm / GroupNorm epsilon; the Swin ``rel_bias``, the ViT ``pos_embed``
and CBAM's ``fc1`` / ``fc2`` cross ``convert`` both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.models import transformers as jtr
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import (flax_to_torch,
                                                      load_flax,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.models import transformers as ttr
from eyediseasesegmentation_tpu_torch.models.encoders import get_encoder
from eyediseasesegmentation_tpu_torch.models.modules import layers
from test_torch_zoo import _bit_equal
from test_torch_zoo_extra import (_hold, _input, _jax_forward,
                                  _port_variables, check_family)

SMALL_TOL = 1e-5                 # × max|output|, fp32, one block
AT_64 = {"input_size": 64}

# (registry name, model params, input side)
FAMILIES = {
    "swin_tiny_attunet": ("swin_tiny_attunet", AT_64, 64),
    "swinformer_star": ("SwinformerStar", AT_64, 64),
    "transunet_r50": ("transunet_r50", AT_64, 64),
    "transunet_b16": ("transunet_b16", AT_64, 64),
    "transunet_v2_narrow": ("TransUnet_V2", {"inplanes": 16, "vit_blocks": 2,
                                             "input_size": 64}, 64),
}


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    check_family(*FAMILIES[family])


def test_segformer_star_heads_match_jax():
    """SegFormerStar built with its deep supervision and classification
    heads (``training=True`` keeps them), run in eval mode: the merged
    logits, the four side outputs [s4..s1] at the input's size and the
    class logits, against JAX."""
    params = {"deep_supervision": True, "clf_head": True}
    x = _input(64)
    tmodel, variables = _port_variables("SegFormerStar", params,
                                        training=True)
    jmodel = jzoo.get_model("SegFormerStar", params, training=True,
                            dtype=jnp.float32)
    combined, deeps, clf = _jax_forward(jmodel, variables, jnp.asarray(x),
                                        train=False)
    with torch.no_grad():
        t_combined, t_deeps, t_clf = tmodel(_nchw(x))
    assert len(t_deeps) == 4 and t_clf.shape == (1, 1)
    _hold([_nhwc(t) for t in [t_combined] + t_deeps] + [t_clf.numpy()],
          [np.asarray(a) for a in [combined] + list(deeps) + [clf]],
          "SegFormerStar heads")


def _random_block(module, seed):
    tzoo.init_random(module, torch.Generator().manual_seed(seed))
    return module, torch_to_flax(module)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_pads_and_shifts_as_jax(shift):
    """A Swin block on 2 images of 9×11 (padded to 14×14 after its
    LayerNorm; shifted by 3 with the mask of the padded canvas, or
    unshifted with the pad tokens unmasked) against JAX's."""
    block, variables = _random_block(ttr.SwinBlock(16, 2, 7, shift,
                                                   side=9), 3 + shift)
    x = np.random.RandomState(5).standard_normal((2, 9, 11, 16))
    x = x.astype(np.float32)
    want = _jax_forward(jtr.SwinBlock(16, 2, 7, shift), variables, x)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert tuple(variables["params"]["WindowAttention_0"]["rel_bias"]
                 .shape) == (169, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SMALL_TOL * float(np.abs(want).max()))


def test_std_conv_matches_jax():
    """Weight standardisation alone (a GroupNorm after it hides a scale
    common to a group): the kernel normalised per output channel with the
    biased variance and eps 1e-5, then a 3×3 / 2 conv with pad 1."""
    conv, variables = _random_block(torch.nn.Conv2d(4, 8, 3, bias=False), 8)
    x = np.random.RandomState(7).standard_normal((1, 9, 9, 4))
    x = x.astype(np.float32)
    want = np.asarray(_jax_forward(
        jtr.StdConv(8, 3, 2, [(1, 1), (1, 1)]), variables, x))
    with torch.no_grad():
        got = _nhwc(ttr.std_conv2d(_nchw(x), conv, torch.float32, 2, 1))
    assert got.shape == want.shape == (1, 5, 5, 8)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SMALL_TOL * float(np.abs(want).max()))


def test_preact_bottleneck_matches_jax():
    """A stride-2 ResNetV2 bottleneck with its projection: weight
    standardisation (biased variance, eps 1e-5) and GroupNorms at eps
    1e-6, against JAX's on an odd (15²) map."""
    block, variables = _random_block(
        ttr.PreActBottleneck(32, 64, 32, strides=2), 7)
    x = np.random.RandomState(6).standard_normal((1, 15, 15, 32))
    x = x.astype(np.float32)
    want = np.asarray(_jax_forward(
        jtr.PreActBottleneck(64, 32, strides=2), variables, x))
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    assert got.shape == want.shape == (1, 8, 8, 64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SMALL_TOL * float(np.abs(want).max()))


def test_gelu_and_norm_epsilons_match_flax():
    """The port's ``gelu`` is jax.nn.gelu's tanh form (the exact form is
    off by more than 1e-4); its LayerNorm and GroupNorm use flax's 1e-6
    epsilon, which shows on a map of standard deviation 1e-3 (torch's
    default 1e-5 is off there)."""
    rng = np.random.RandomState(8)
    x = rng.standard_normal((4, 64)).astype(np.float32) * 3
    want = np.asarray(jax.nn.gelu(x))
    got = layers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4

    small = (rng.standard_normal((2, 4, 4, 64)) * 1e-3).astype(np.float32)
    ln, ln_vars = _random_block(layers.LayerNorm(64), 9)
    gn, gn_vars = _random_block(ttr.GroupNorm(32, 64), 9)
    assert ln.eps == gn.eps == 1e-6
    want = [np.asarray(_jax_forward(nn.LayerNorm(), ln_vars, small)),
            np.asarray(_jax_forward(
                nn.GroupNorm(num_groups=32, epsilon=1e-6), gn_vars, small))]
    for eps in (1e-6, 1e-5):
        ln.eps = gn.eps = eps
        with torch.no_grad():
            got = [ln(torch.from_numpy(small)).numpy(),
                   _nhwc(gn(_nchw(small)))]
        for g, w in zip(got, want):
            close = np.abs(g - w).max() <= SMALL_TOL * np.abs(w).max()
            assert close == (eps == 1e-6), (eps, np.abs(g - w).max())


class _Leaves(layers.PortModule):
    """A Swin window attention, a CBAM and a position embedding: the three
    leaf kinds this slice adds to ``convert``."""

    def __init__(self):
        super().__init__()
        self.attn = ttr.WindowAttention(8, 2, window=3)
        self.cbam = layers.CBAM(32)
        self.pos_embed = torch.nn.Parameter(torch.zeros(1, 4, 8))


def test_rel_bias_pos_embed_and_cbam_cross_convert():
    """``rel_bias`` and ``pos_embed`` keep their names and layouts (not the
    ``<name>_bias`` rule, no KeyError) and CBAM's channel MLP is flax's
    ``CBAMChannel_0/Dense_0, Dense_1``; ``torch_to_flax`` → ``load_flax``
    gives the weights back bit for bit."""
    module, variables = _random_block(_Leaves(), 10)
    params = variables["params"]
    assert params["attn"]["rel_bias"].shape == (25, 2)
    assert params["pos_embed"].shape == (1, 4, 8)
    assert set(params["cbam"]["CBAMChannel_0"]) == {"Dense_0", "Dense_1"}
    assert params["cbam"]["CBAMChannel_0"]["Dense_0"]["kernel"].shape == \
        (32, 2)
    state = {k: v.clone() for k, v in module.state_dict().items()}
    assert {"attn.rel_bias", "pos_embed", "cbam.CBAMChannel_0.fc1.weight",
            "cbam.CBAMChannel_0.fc2.bias"} <= set(flax_to_torch(variables))
    load_flax(_Leaves(), variables)
    load_flax(module, variables)
    assert all(torch.equal(module.state_dict()[k], v)
               for k, v in state.items())
    _bit_equal(torch_to_flax(module), variables)


def test_size_dependent_models_refuse_another_input_size():
    """Built for 1024² (the default), TransUNet's ``pos_embed`` and the
    Swin encoder's small-map windows refuse a 64² input, naming
    ``input_size``; the Swin pyramid has the JAX channels."""
    model = tzoo.get_model("transunet_b16", {}, training=False, device="cpu")
    assert tuple(model.pos_embed.shape) == (1, 64 * 64, 256)
    encoder, channels = get_encoder("swin_tiny")
    assert channels == [3, 64, 96, 192, 384, 768]
    x = torch.zeros(1, 3, 64, 64)
    for m in (model, encoder):
        with pytest.raises(ValueError, match="input_size"):
            with torch.no_grad():
                m(x)
