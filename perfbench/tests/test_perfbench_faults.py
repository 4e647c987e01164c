"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at the oracle size (the loop's set-up, window and comparison, the
cell's own limits), with one fault planted in the port: the faults each
cell can have. The same run without a fault comes out correct."""

import pytest
import torch

from perfbench import calibrate
from perfbench.loops import train as DT
from perfbench.loops import tta as DTTA
from perfbench.tests.helpers import tiny_context


def correct(res) -> bool:
    return all(v <= lim for _, v, lim in res.checks) and res.failed == 0


@pytest.mark.parametrize("cell", ["idrid_tta_d4_b3", "drive_tta_d4_b2"])
@pytest.mark.parametrize("fault", ["none", "answer_altered",
                                   "half_batch_scored",
                                   "score_order_flipped", "sweep_shifted"])
def test_tta_faults(cell, fault, monkeypatch):
    from eyediseasesegmentation_tpu_torch.infer import tta as T
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    if fault == "answer_altered":
        predict = T.TTAPredictor.predict

        def altered(self, raw):
            p = predict(self, raw).clone()
            p[0] = p[0] * 0.9          # one image's probabilities
            return p

        monkeypatch.setattr(T.TTAPredictor, "predict", altered)
    elif fault == "half_batch_scored":
        plain = M.batch_image_metrics

        def half(probs, masks, valid=None, score="ap"):
            n = probs.shape[0] // 2
            return plain(probs[:n], masks[:n], n, score=score)

        monkeypatch.setattr(M, "batch_image_metrics", half)
    elif fault in calibrate.METRIC_FAULTS:
        for owner, attr, fn in calibrate.metric_fault(fault):
            monkeypatch.setattr(owner, attr, fn)
    res = DTTA.run(tiny_context(cell, seconds=1.0))
    assert correct(res) == (fault == "none"), res.checks


@pytest.mark.parametrize("fault", ["none", "state_unchanged",
                                   "half_batch_loss", "loss_altered",
                                   "stats_frozen"])
def test_train_faults(fault, monkeypatch):
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    ctx = tiny_context("idrid_train_b2", dtype="float32", seconds=0.5)
    if fault == "state_unchanged":
        build = DT.build_program

        def frozen(c):
            trainer = build(c)
            step = trainer.optimizer.step

            def no_update(*a, **k):    # moments move, parameters do not
                saved = [p.detach().clone()
                         for p in trainer.model.parameters()]
                step(*a, **k)
                with torch.no_grad():
                    for p, s in zip(trainer.model.parameters(), saved):
                        p.copy_(s)

            trainer.optimizer.step = no_update
            return trainer

        monkeypatch.setattr(DT, "build_program", frozen)
    elif fault == "half_batch_loss":
        loss = Trainer.compute_loss

        def half(self, out, m4):
            n = m4.shape[0] // 2
            return loss(self, out[:n], m4[:n])

        monkeypatch.setattr(Trainer, "compute_loss", half)
    elif fault == "loss_altered":
        loss = Trainer.compute_loss

        def altered(self, out, m4):
            total, parts, final = loss(self, out, m4)
            return total * 1.05, parts, final

        monkeypatch.setattr(Trainer, "compute_loss", altered)
    elif fault == "stats_frozen":
        build = DT.build_program

        def frozen(c):
            trainer = build(c)
            calibrate.plant(trainer, fault)
            return trainer

        monkeypatch.setattr(DT, "build_program", frozen)
    res = DT.run(ctx)
    assert correct(res) == (fault == "none"), res.checks
