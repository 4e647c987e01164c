"""The plain reference against the port's plain path at the oracle size
(64², base_dim 2, full widths), on the CPU, in float32."""

import numpy as np
import pytest
import torch

from perfbench.loops import train as DT
from perfbench.loops import tta as DTTA
from perfbench.reference import metrics as RM
from perfbench.reference import model as R
from perfbench.tests.helpers import tiny_context
from perfbench.weights import make_weights


def test_state_dicts_match_and_eval_forward_agrees():
    from eyediseasesegmentation_tpu_torch import models as zoo

    ctx = tiny_context("idrid_tta_d4_b3")
    cfg = ctx.config
    ref = R.build(cfg)
    port = zoo.get_model(cfg["model_name"], dict(cfg["model_params"]),
                         training=False, device="cpu")
    assert set(ref.state_dict()) == set(port.state_dict())
    w = make_weights(ref, 7, "cpu")
    ref.load_state_dict(w)
    port.load_state_dict(w)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref(x), port(x)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()


@pytest.mark.parametrize("cell", ["idrid_tta_d4_b3", "drive_tta_d4_b2"])
def test_tta_pass_agrees(cell):
    ctx = tiny_context(cell, seconds=1.0)
    ctx.limits = dict.fromkeys(["prob_max", "logit_rel_max", "count_gap",
                                "score_gap", "sweep_gap",
                                "logit_max_x_bf16"], 1.0)
    res = DTTA.run(ctx)
    nums = {n: v for n, v, _ in res.checks}
    assert nums["prob_max"] < 1e-5
    assert nums["logit_rel_max"] < 1e-3
    assert nums["logit_max_x_bf16"] < 1e-2     # float32 against bfloat16
    assert nums["count_gap"] == 0.0
    assert nums["score_gap"] < 1e-5
    assert nums["sweep_gap"] < 1e-3
    assert res.attempted >= 2


@pytest.mark.parametrize("score", ["ap", "roc"])
def test_metrics_agree_with_ties(score):
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    g = torch.Generator().manual_seed(3)
    probs = torch.rand((3, 40, 50), generator=g)
    probs = torch.round(probs * 64) / 64          # many ties
    masks = (torch.rand((3, 40, 50), generator=g) > 0.8).to(torch.uint8)
    masks[2] = 0                                  # no positive: left out
    p = M.batch_image_metrics(probs, masks, 3, score=score)
    r = RM.batch_totals(probs, masks, 3, score)
    assert float(p["ap_count"]) == float(r["ap_count"]) == 2.0
    assert abs(float(p["ap_sum"]) - float(r["ap_sum"])) < 1e-6
    for k in ("tp", "pp", "tn", "ap"):
        assert np.array_equal(p[k].double().numpy(), r[k].numpy()), k
    assert float(p["px"]) == float(r["px"])


def test_first_train_step_agrees():
    ctx = tiny_context("idrid_train_b2")
    trainer = DT.build_program(ctx)
    pool = DT.make_pool(ctx)
    losses, grads, logits = DT.compared_steps(
        trainer, pool, torch.Generator().manual_seed(ctx.seed), 1)
    ref = DT.reference_steps(ctx, pool)
    yard = DT.bf16_first_logits(ctx, pool)
    nums = DT.numbers_of(losses, grads, logits, trainer.model.state_dict(),
                         ref, yard)
    assert nums["first_loss_gap"] < 1e-5
    assert nums["first_logit_x_bf16"] < 1e-2    # float32 against bfloat16
    # float32 on both sides: the first gradient's worst leaf (the
    # cross-axial gates' at this size) within a few per cent
    assert nums["grad_gap"] < 5e-2
    assert nums["update_gap_median"] < 1e-2
