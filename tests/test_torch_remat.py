"""Port: ``remat``, activations recomputed in the backward.

The flagship at ``base_dim=2`` (64², fp32, DropBlock on at 0.3) takes one
``Trainer.train_step`` with and without ``remat`` from the same weights,
batch and generators: the loss, every gradient leaf (within 1e-6 of the
leaf's largest) and every running statistic after the step agree. With
``remat`` the flagship checkpoints each encoder block and decoder node;
``classic_unet``, which has no such field, the whole model in one segment
(the trainer's fallback). Each of the two traps has its own test: a
recomputed BatchNorm computes its batch statistics again but moves its
running statistics once, and a recomputed DropBlock draws its mask again
from the explicit generator's state at the forward, leaving the generator
where the backward found it.
"""

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch.models import get_model
from eyediseasesegmentation_tpu_torch.models.modules import layers
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    BatchNorm, ConvBNReLU, remat, set_generator)
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer
from eyediseasesegmentation_tpu_torch.utils import fold_in

GRAD_TOL = 1e-6          # of each leaf's largest magnitude
CHECKPOINT = layers.checkpoint
CONFIG = {"scale_size": 64, "batch_size": 2, "is_fp16": False,
          "augmentation": "none", "criterion": {"bce": 0.8, "log_dice": 0.2},
          "optimizer": "adamw", "learning_rate": 1e-3}
MODELS = {
    "unetplusplusstar": {"encoder_name": "BoTSER50_Axial_Imagenet_3",
                         "decoder_attention_type": "scse", "base_dim": 2,
                         "classes": 1, "drop_block_prob": 0.3},
    "classic_unet": {"filters": [8, 16], "classes": 1},
}


def _batch():
    rng = np.random.RandomState(0)
    imgs = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    masks = (rng.rand(2, 64, 64) < 0.3).astype(np.float32)
    return imgs, masks


def _step(name, remat_on, monkeypatch):
    """(trainer, metrics, segments) of one train step; ``segments`` counts
    the checkpointed calls."""
    calls = []

    def counting(*a, **k):
        calls.append(a[0])
        return CHECKPOINT(*a, **k)

    monkeypatch.setattr(layers, "checkpoint", counting)
    tr = Trainer({**CONFIG, "model_name": name, "model_params": MODELS[name],
                  "remat": remat_on}, seed=7, device="cpu")
    metrics = tr.train_step(*_batch(), torch.Generator().manual_seed(3),
                            1e-3)
    return tr, metrics, calls


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_matches_the_step_without(name, monkeypatch):
    plain, m0, c0 = _step(name, False, monkeypatch)
    rem, m1, c1 = _step(name, True, monkeypatch)
    assert c0 == []
    if name == "unetplusplusstar":
        # 13 SE bottlenecks, 3 axial block calls, 11 decoder nodes
        assert rem._model_remat and len(c1) == 27
    else:
        assert not rem._model_remat and c1 == [rem.model]
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    grads = dict(plain.model.named_parameters())
    for k, p in rem.model.named_parameters():
        g0, g1 = grads[k].grad, p.grad
        top = max(float(g0.abs().max()), 1e-30)
        assert float((g1 - g0).abs().max()) <= GRAD_TOL * top, k
    bufs = dict(plain.model.named_buffers())
    for k, b in rem.model.named_buffers():
        torch.testing.assert_close(b, bufs[k], rtol=0, atol=1e-7, msg=k)


def test_remat_moves_running_stats_once():
    """A block recomputed in the backward: the BatchNorm's running mean
    and variance move by one batch, not two."""
    torch.manual_seed(0)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    blocks = []
    for on in (False, True):
        block = ConvBNReLU(4, 6, drop_block_prob=0.0).train()
        torch.manual_seed(1)
        torch.nn.init.normal_(block.conv.weight)
        remat(block, x, enabled=on).square().sum().backward()
        blocks.append(block.bn)
    ref, got = blocks
    assert not torch.equal(ref.running_mean, torch.zeros(6))
    torch.testing.assert_close(got.running_mean, ref.running_mean,
                               rtol=0, atol=0)
    torch.testing.assert_close(got.running_var, ref.running_var,
                               rtol=0, atol=0)


def test_remat_replays_explicit_generators():
    """DropBlock draws from the module's own generator: the recompute draws
    the forward's mask again (the input gradient equals the plain one),
    and the generator ends where the plain run leaves it."""
    torch.manual_seed(0)
    x0 = torch.randn(2, 4, 16, 16)
    out = []
    for on in (False, True):
        block = ConvBNReLU(4, 6, drop_block_prob=0.3).train()
        torch.manual_seed(1)
        torch.nn.init.normal_(block.conv.weight)
        gen = fold_in(torch.Generator().manual_seed(5), 0)
        set_generator(block, gen)
        x = x0.clone().requires_grad_(True)
        y = remat(block, x, enabled=on)
        torch.rand(3, generator=gen)          # a later draw before backward
        (y * torch.linspace(0, 1, y.numel()).view(y.shape)).sum().backward()
        out.append((y.detach(), x.grad, torch.rand(4, generator=gen)))
    (y0, g0, next0), (y1, g1, next1) = out
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(g1, g0, rtol=0, atol=0)
    torch.testing.assert_close(next1, next0, rtol=0, atol=0)


def test_models_without_the_field_refuse_it():
    with pytest.raises(TypeError, match="remat"):
        get_model("classic_unet", {"filters": [8, 16], "remat": True},
                  device="cpu")
    model = get_model("unetplusplusstar", {**MODELS["unetplusplusstar"],
                                           "remat": True}, device="cpu")
    assert model.decoder.remat and model.encoder.remat
