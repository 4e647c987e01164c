"""Port parity: the zoo families on the ResNet encoders or on no encoder
(Unet, UNet++, Attention U-Net, FPN, DeepLabV3+, the classic U-Nets)
against the JAX package, and every registered name of the port.

Each family runs once per encoder kind at 64² in fp32, its flax variables
filled from a numpy seed (BatchNorm statistics away from the identity) and
converted into the port with ``convert.load_flax``: logits within 1e-4 ×
max|logit|. Unet and the non-star UNet++ on the axial encoder fit 1024²
only (both build it at the default ``base_dim``), so here their pieces are
composed as the classes compose them, with the encoder at ``base_dim=2``.
Every registered name builds and forwards in the port on the CPU, and its
weights cross ``torch_to_flax`` and back unchanged.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.models.decoders import (
    UnetDecoder as JUnetDecoder, UnetPlusPlusDecoder as JUnetPlusPlusDecoder)
from eyediseasesegmentation_tpu.models.encoders import (
    get_encoder as jget_encoder)
from eyediseasesegmentation_tpu.models.modules.layers import (
    SegmentationHead as JSegmentationHead)
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.convert import (_leaves, flax_to_torch,
                                                      load_flax,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.models.encoders import get_encoder

SIZE = 64
AXIAL = "BoTSER50_Axial_Imagenet_3"
TOL = 1e-4                       # × max|logit|, fp32, the whole network
CLASSIC = {"filters": [8, 16, 32]}
# the names the port registers besides the flagship
PORTED = ["unetplusplus_deepsup", "UnetPlusPlus", "Unet", "resnet18_unet32",
          "resnet34_unet32", "resnet50_unet32", "seresnet50_unet32",
          "resnet50_attunet", "seresnet50_attunet", "rrcnn_unet", "sa_unet",
          "classic_unet", "LeeJunHyun_impl_att", "LeeJunHyun_impl_R2U_Net",
          "LeeJunHyun_impl_R2AttU_Net", "resnet34_fpncat128",
          "seresnext50_fpncat128", "resnet152_fpncat256", "FPN",
          "resnet34_deeplab128", "deeplabv3plus_deepsup",
          "seresnext101_deeplab256", "DeepLabV3Plus"]
# the names of UNet 3+, smp_extra's families, the EfficientNet /
# MobileNetV3 and Swin encoders, the transformer families and misc.py's
# families (tests/test_torch_zoo_extra.py builds them)
PORTED_EXTRA = ["Unet3Plus_Base", "Unet3Plus_DS", "Linknet", "PSPNet",
                "DeepLabV3", "PAN", "MAnet", "b4_unet32", "b2_effunet32",
                "b4_effunet32", "efficientnetb2_attunet",
                "mobilenetv3_attunet", "b2_fpn_cat", "swin_tiny_attunet",
                "swin_small_attunet", "transunet_r50", "transunet_b16",
                "TransUnet_V2", "SegFormerStar", "SwinformerStar",
                "hrnet18", "hrnet34", "hrnet48", "resnet50_doubleunet",
                "efficientnetb2_doubleunet", "mobilenetv3_doubleunet",
                "vgg_doubleunet", "unet_resnext50_ssl", "hed_unet",
                "hed_resunet", "hed_denseunet", "axialatt_unet", "gated",
                "medt", "logo", "axialattwopo_unet", "dcunet",
                "resunetplusplus", "hubmap_kaggle"]


class JAxialPieces(nn.Module):
    """Unet (``plusplus`` False) or the non-star UnetPlusPlus (True) as the
    JAX classes compose them, with the axial encoder at ``base_dim=2``."""

    plusplus: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        encoder, channels = jget_encoder(AXIAL, base_dim=2)
        feats = encoder(x, train)
        if not self.plusplus:
            y = JUnetDecoder(encoder_channels=channels,
                             attention_type="scse", name="decoder")(feats)
            return JSegmentationHead(1, name="segmentation_head")(y)
        final, deeps = JUnetPlusPlusDecoder(
            encoder_channels=channels, attention_type="scse",
            deep_supervision=True, star=False, drop_block_prob=0.0,
            name="decoder")(feats)
        return (JSegmentationHead(1, name="segmentation_head")(final),
                [JSegmentationHead(1, name=f"deep_head{i}")(f)
                 for i, f in enumerate(deeps)])


# (registry name, model params, training): the JAX model comes from the
# JAX registry, the port's from the port's; `training` keeps the heads
FAMILIES = {
    "unet_resnet34_basic": ("resnet34_unet32", {}, False),
    "attunet_resnet50_bottleneck": ("resnet50_attunet", {}, False),
    "fpn_seresnext50_grouped": ("seresnext50_fpncat128", {}, False),
    "deeplab_resnet34_deepsup": ("resnet34_deeplab128",
                                 {"deep_supervision": True}, True),
    "unet_axial_pieces": ("Unet", {"encoder_name": AXIAL,
                                   "decoder_attention_type": "scse"}, False),
    "unetplusplus_axial_pieces_deepsup": (
        "UnetPlusPlus", {"encoder_name": AXIAL, "deep_supervision": True,
                         "decoder_attention_type": "scse"}, True),
    "classic_unet": ("classic_unet", CLASSIC, False),
    "sa_unet": ("sa_unet", CLASSIC, True),
    "r2unet": ("rrcnn_unet", CLASSIC, False),
    "attunet_classic": ("LeeJunHyun_impl_att", CLASSIC, False),
    "r2attunet": ("LeeJunHyun_impl_R2AttU_Net", CLASSIC, False),
}


# outputs of one forward where more than the mask: the heads kept
OUTPUTS = {"deeplab_resnet34_deepsup": 2,
           "unetplusplus_axial_pieces_deepsup": 4}


def _jax_model(name, params, training):
    if params.get("encoder_name") == AXIAL:
        return JAxialPieces(plusplus=name == "UnetPlusPlus")
    return jzoo.get_model(name, params, training=training,
                          dtype=jnp.float32)


def _port_model(name, params, training):
    model = tzoo.get_model(name, params, training=training, device="cpu")
    if params.get("encoder_name") == AXIAL:
        model.encoder = get_encoder(AXIAL, base_dim=2)[0]
    return model


def _flat(out):
    """The outputs of one forward as a list of NHWC numpy arrays."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    a = np.asarray(out.detach().permute(0, 2, 3, 1).numpy()
                   if isinstance(out, torch.Tensor) else out)
    return [a]


def random_variables(shapes, seed):
    """``test_torch_axial.random_flax_variables``' kinds and scales, drawn
    in fp32 by numpy's faster generator (the zoo's encoders are full
    width)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("scale"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        a = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("mean") or name.endswith("bias"):
            return a * np.float32(0.1)
        return a * np.float32(1.0 / np.sqrt(np.prod(shape[:-1])))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _bit_equal(got, want):
    got = dict(_leaves(got))
    want = {p: np.asarray(v) for p, v in _leaves(want)}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    """The forward against JAX at 64² in fp32 (every head: deep
    supervision where the case keeps it), and the weights across
    ``convert`` and back, both ways, bit for bit."""
    name, params, training = FAMILIES[family]
    x = np.random.RandomState(1).uniform(-1, 1, (1, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    jmodel = _jax_model(name, params, training)
    shapes = jax.eval_shape(partial(jmodel.init, train=False),
                            {"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = random_variables(shapes, seed=11)
    apply = jax.jit(partial(jmodel.apply, train=False))
    want = _flat(apply(variables, jnp.asarray(x)))
    tmodel = load_flax(_port_model(name, params, training), variables)
    with torch.no_grad():
        got = _flat(tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == len(want) == OUTPUTS.get(family, 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= TOL * scale, (family, err, scale)
    state = tmodel.state_dict()
    _bit_equal(torch_to_flax(state), variables)
    back = flax_to_torch(variables)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], v) for k, v in state.items())


@pytest.mark.parametrize("name", PORTED)
def test_registered_name_builds_and_forwards(name):
    """Each name at its registry defaults (full width), with the inference
    demotions, on the CPU: finite fp32 logits at the input's size."""
    model = tzoo.get_model(name, {}, training=False, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 1, 32, 32) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_registry_lists_the_ported_names():
    """The port's registry is the JAX package's, names and order; an
    unknown name raises KeyError in both, and so do the encoder names
    that only a model resolves itself (``vgg``, ``hrnet18``)."""
    assert sorted(tzoo.list_models()) == sorted(
        PORTED + PORTED_EXTRA + ["unetplusplusstar"])
    assert tzoo.list_models() == jzoo.list_models()
    for get in (tzoo.get_model, jzoo.get_model):
        with pytest.raises(KeyError, match="Cannot find"):
            get("hrnet64", {})
    for encoder in ("vgg", "hrnet18"):
        for get in (get_encoder, jget_encoder):
            with pytest.raises(KeyError, match="Unknown encoder"):
                get(encoder)
