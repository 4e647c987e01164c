"""Port parity: ``misc.py``'s families on an encoder trunk (DoubleU-Net
on VGG and on a ResNet, HRNet, UneXt50 and the HuBMAP SE-ResNeXt101
U-Net) against the JAX package at 64² in fp32, as
``test_torch_zoo_extra.check_family`` holds them: every output within
1e-4 × max|output| on the port's ``init_random`` weights carried to JAX by
``convert.torch_to_flax``. HRNet runs at width 4 with one exchange module
a stage (every fusion of 2, 3 and 4 branches); HuBMAP with its classifier,
early exit and deep supervision.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from test_torch_zoo import _flat
from test_torch_zoo_extra import (_hold, _input, _jax_forward,
                                  _port_variables, check_family)

# (registry name, model params, input side)
FAMILIES = {
    "vgg_doubleunet": ("vgg_doubleunet", {}, 64),
    "doubleunet_resnet18": ("resnet50_doubleunet",
                            {"encoder_name": "resnet18"}, 64),
    "hrnet_w4": ("hrnet18", {"width": 4, "stage_modules": [1, 1, 1]}, 64),
    "unext50": ("unet_resnext50_ssl", {"decoder_channels": [16, 16, 8, 8]},
                64),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    check_family(*FAMILIES[family])


def test_hubmap_classifier_early_exit_and_deep_supervision_match_jax():
    """``hubmap_kaggle`` at ``decoder_channels`` 16 with its classifier,
    deep supervision and ``clf_threshold`` 0.99, built with
    ``training=True`` and run in eval on 2 images. The classifier's bias is
    moved so that 0.99 falls between the two images' probabilities: one
    keeps its logits, the other is set to −100. Logits, the four side
    outputs and the class logits against JAX."""
    params = {"decoder_channels": 16, "clf_threshold": 0.99,
              "deep_supervision": True}
    x = np.concatenate([_input(64, seed=3), _input(64, seed=4) * 0.5])
    tmodel, _ = _port_variables("hubmap_kaggle", params, training=True)
    with torch.no_grad():
        clf = tmodel(_nchw(x))[2][:, 0]
        assert float(clf[0]) != float(clf[1])
        tmodel.Dense_1.bias += float(np.log(99.0) - clf.mean())
        logits, deeps, clf = tmodel(_nchw(x))
    keep = torch.sigmoid(clf[:, 0]) > 0.99
    assert bool(keep[0]) != bool(keep[1])
    assert bool((logits[~keep] == -100.0).all())
    assert len(deeps) == 4 and [d.shape[2] for d in deeps] == [4, 8, 16, 32]
    jmodel = jzoo.get_model("hubmap_kaggle", params, training=True,
                            dtype=jnp.float32)
    j_logits, j_deeps, j_clf = _jax_forward(
        jmodel, torch_to_flax(tmodel), jnp.asarray(x), train=False)
    _hold(_flat([logits, deeps]) + [clf.numpy()],
          _flat([j_logits, j_deeps]) + [np.asarray(j_clf)], "hubmap_kaggle")
