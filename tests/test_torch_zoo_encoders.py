"""Port parity: the EfficientNet-b2, MobileNetV3 and DenseNet-121 encoders
under the decoders that use them in the registry, and the flagship on
``BoTSER50_Imagenet`` (SE-ResNet50 with three SE bottlenecks as layer4, at
``base_dim=2`` for its decoder's cross-axial gates), against the JAX
package at 64² in fp32, as ``test_torch_zoo_extra.check_family`` holds
them: the same weights on both sides, one variable tree, logits within
1e-4 × max|logit|. The stride-2 convs of EfficientNet and MobileNetV3 pad
as flax's SAME does, asymmetrically on an even map. The names on
EfficientNet-b4 are built and round-tripped here.
"""

import pytest

from test_torch_zoo_extra import ON_B4, check_family, check_registered

# (registry name, model params, input side)
FAMILIES = {
    "unet_efficientnet_b2": ("b2_effunet32", {}, 64),
    "attunet_mobilenetv3": ("mobilenetv3_attunet", {}, 64),
    "fpn_efficientnet_b2": ("b2_fpn_cat", {}, 64),
    "unet_densenet121": ("Unet", {"encoder_name": "densenet121"}, 64),
    "flagship_botser50_imagenet": (
        "unetplusplusstar", {"encoder_name": "BoTSER50_Imagenet",
                             "base_dim": 2, "decoder_attention_type": "scse"},
        64),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    check_family(*FAMILIES[family])


@pytest.mark.parametrize("name", ON_B4)
def test_registered_name_builds_and_round_trips(name):
    """The names on EfficientNet-b4 build and forward at 64², and their
    weights round-trip (``test_torch_zoo_extra.check_registered``)."""
    check_registered(name)
