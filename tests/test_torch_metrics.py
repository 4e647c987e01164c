"""Port parity: ``ops/metrics.py`` and ``analysis/aucpr.py`` of the torch port
against the JAX package's, on the same numpy inputs.

A batch of 3 images of 24×32 with 2 valid, the second with an empty mask;
probabilities quantized to 1/256, so every tie-block of the AP and ROC sorts
has several members and some pixels sit exactly on a threshold (0, 0.5, 1).
Counts (TP, AP, PP, TN, pixels) must be equal; AP, ROC-AUC, the per-image
statistics and the curve reports agree within 1e-6; optimal thresholds are
identical.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu.analysis import aucpr as JA
from eyediseasesegmentation_tpu.ops import metrics as JM
from eyediseasesegmentation_tpu_torch.analysis import aucpr as TA
from eyediseasesegmentation_tpu_torch.ops import metrics as TM

TOL = 1e-6
COUNTS = ("tp", "ap", "pp", "tn", "px")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    probs = (rng.randint(0, 257, (3, 24, 32)) / 256.0).astype(np.float32)
    masks = (rng.uniform(size=(3, 24, 32)) < 0.3).astype(np.float32)
    masks[1] = 0.0                       # an empty ground truth
    # positives score higher on average, so AP and AUC are far from 0.5
    probs = np.where(masks > 0, np.minimum(probs + 0.25, 1.0), probs)
    probs = (np.round(probs * 256) / 256).astype(np.float32)
    return probs, masks


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("score", ["ap", "roc"])
def test_batch_image_metrics_matches_jax(score):
    probs, masks = _batch()
    want = jax.jit(partial(JM.batch_image_metrics, score=score))(
        jnp.asarray(probs), jnp.asarray(masks.astype(np.uint8)), 2)
    got = TM.batch_image_metrics(torch.from_numpy(probs),
                                 torch.from_numpy(masks.astype(np.uint8)), 2,
                                 score=score)
    assert set(got) == set(want)
    for k in COUNTS + ("ap_count",):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    np.testing.assert_allclose(_np(got["ap_sum"]), _np(want["ap_sum"]),
                               rtol=0, atol=TOL)
    # the valid mask as a (B,) bool gives the same
    again = TM.batch_image_metrics(torch.from_numpy(probs),
                                   torch.from_numpy(masks),
                                   torch.tensor([True, True, False]),
                                   score=score)
    for k in got:
        np.testing.assert_array_equal(_np(again[k]), _np(got[k]), err_msg=k)


@pytest.mark.parametrize("fn", ["average_precision", "roc_auc"])
def test_scores_match_jax(fn):
    probs, masks = _batch(1)
    jfn = jax.jit(getattr(JM, fn))
    for i in range(3):
        want = float(jfn(jnp.asarray(probs[i]), jnp.asarray(masks[i])))
        got = float(getattr(TM, fn)(torch.from_numpy(probs[i]),
                                    torch.from_numpy(masks[i])))
        assert abs(got - want) <= TOL, (fn, i, got, want)


@pytest.mark.parametrize("valid", [False, True], ids=["all", "valid_mask"])
def test_threshold_sweep_matches_jax(valid):
    probs, masks = _batch(2)
    vmask = (np.arange(32) < 20).astype(np.float32)
    vmask = np.broadcast_to(vmask, probs.shape) if valid else None
    want = JM.threshold_sweep(jnp.asarray(probs), jnp.asarray(masks),
                              valid_mask=None if vmask is None
                              else jnp.asarray(vmask))
    got = TM.threshold_sweep(torch.from_numpy(probs), torch.from_numpy(masks),
                             valid_mask=None if vmask is None
                             else torch.from_numpy(vmask.copy()))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (19,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hard_scores_and_per_image_stats_match_jax():
    probs, masks = _batch(3)
    for i in range(3):
        p, g = probs[i], masks[i]
        for fn in ("dice_coeff", "iou_coeff"):
            want = float(getattr(JM, fn)(jnp.asarray(p), jnp.asarray(g)))
            got = float(getattr(TM, fn)(torch.from_numpy(p),
                                        torch.from_numpy(g)))
            assert abs(got - want) <= TOL, (fn, i)
        pred = (p > 0.5).astype(np.float32)
        want = JM.per_image_stats(jnp.asarray(pred), jnp.asarray(g))
        got = TM.per_image_stats(torch.from_numpy(pred), torch.from_numpy(g))
        assert set(got) == set(want)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= TOL, (k, i)


def test_curve_helpers_match_jax():
    probs, masks = _batch(4)
    tp, ap, pp, tn = (np.array(c) for c in JM.threshold_sweep(
        jnp.asarray(probs), jnp.asarray(masks)))
    t = {k: torch.from_numpy(v) for k, v in
         dict(tp=tp, ap=ap, pp=pp, tn=tn).items()}
    sn, ppv = JM.pr_from_counts(tp, ap, pp)
    tsn, tppv = TM.pr_from_counts(t["tp"], t["ap"], t["pp"])
    np.testing.assert_allclose(tsn.numpy(), np.asarray(sn), rtol=0, atol=TOL)
    np.testing.assert_allclose(tppv.numpy(), np.asarray(ppv), rtol=0,
                               atol=TOL)
    total = float(probs.size)
    rsn, fpr = JM.roc_from_counts(tp, ap, tn, total)
    trsn, tfpr = TM.roc_from_counts(t["tp"], t["ap"], t["tn"], total)
    np.testing.assert_allclose(trsn.numpy(), np.asarray(rsn), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tfpr.numpy(), np.asarray(fpr), rtol=0,
                               atol=TOL)
    # increasing and decreasing x
    for x, y in ((sn, ppv), (fpr, rsn), (np.asarray(sn)[::-1].copy(),
                                         np.asarray(ppv)[::-1].copy())):
        want = float(JM.auc_trapezoid(jnp.asarray(x), jnp.asarray(y)))
        got = float(TM.auc_trapezoid(torch.from_numpy(np.asarray(x)),
                                     torch.from_numpy(np.asarray(y))))
        assert abs(got - want) <= TOL
    want = [float(v) for v in JM.optimal_thresholds(sn, ppv)]
    got = [float(v) for v in TM.optimal_thresholds(tsn, tppv)]
    assert got == want


@pytest.mark.parametrize("report", ["pr", "roc"])
def test_curve_reports_match_jax(report):
    probs, masks = _batch(5)
    sweep = JM.threshold_sweep(jnp.asarray(probs), jnp.asarray(masks))
    c = dict(zip(("tp", "ap", "pp", "tn"), (np.array(v) for v in sweep)))
    c["px"] = np.float32(probs.size)
    if report == "pr":
        args = (c["tp"], c["ap"], c["pp"], "exp")
        want, got = JA.pr_curve_report(*args), TA.pr_curve_report(*args)
    else:
        args = (c["tp"], c["ap"], c["tn"], float(c["px"]), "exp")
        want = JA.roc_curve_report(*args, pp=c["pp"])
        got = TA.roc_curve_report(*args, pp=c["pp"])
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
