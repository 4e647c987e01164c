"""Closed-loop test passes through ``infer.tta.tta_pass``.

The traffic file gives the test split (images, their size and an optional
square pad, the batch), the TTA alias, the score (``ap`` or ``roc``),
whether images are resized, the mask density and how many batches warm up
and how many are checked. The images and masks are made on the device from
the seed and held on the host as uint8 numpy arrays, batched as
``batch_iterator`` yields them; every seed gets the same sizes.

The window runs passes back to back, each a fresh ``tta_pass`` over the
split; a pass stops taking batches once the window's time is up, and the
probabilities of a pass are dropped before the next starts. ``images_per_s``
counts the images whose probabilities and metrics are complete when the
pass returns (its metrics come to the host there), over the window's
seconds. Afterwards batches of the last pass, drawn from the seed, are
compared with the plain reference: probabilities, and the batch's metric
totals as ``batch_image_metrics`` returned them to ``tta_pass``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench import common
from perfbench.common import Context, Result, exact_float32
from perfbench.reference import metrics as RM
from perfbench.reference import tta as RT
from perfbench.weights import make_weights


def make_batches(ctx: Context) -> List[dict]:
    """The test split as host batches (``image`` uint8 (B, H, W, 3),
    ``mask`` uint8 (B, H, W), ``filename``, ``n_valid``)."""
    tr = ctx.traffic
    n, bsz = int(tr["images"]), int(tr["batch"])
    if n % bsz:
        raise ValueError("the split must fill its batches")
    h, w = tr["image_hw"]
    ph, pw = tr.get("pad_to") or (h, w)
    top, left = (ph - h) // 2, (pw - w) // 2
    gen = ctx.device_gen(1)
    dev = ctx.device
    out = []
    for i in range(0, n, bsz):
        img = torch.zeros((bsz, ph, pw, 3), dtype=torch.uint8, device=dev)
        mask = torch.zeros((bsz, ph, pw), dtype=torch.uint8, device=dev)
        img[:, top:top + h, left:left + w] = torch.randint(
            0, 256, (bsz, h, w, 3), generator=gen, device=dev,
            dtype=torch.uint8)
        field = torch.rand((bsz, 1, h // 32 + 2, w // 32 + 2),
                           generator=gen, device=dev)
        field = F.interpolate(field, size=(h, w), mode="bilinear",
                              align_corners=False)[:, 0]
        mask[:, top:top + h, left:left + w] = (
            field > float(tr["mask_threshold"])).to(torch.uint8)
        out.append({"image": img.cpu().numpy(), "mask": mask.cpu().numpy(),
                    "filename": [f"{i + j:03d}.png" for j in range(bsz)],
                    "n_valid": bsz})
    return out


def build_program(ctx: Context):
    """The port's ``TTAPredictor`` for the cell, its weights the
    benchmark's."""
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.infer import tta as T

    cfg, tr = ctx.config, ctx.traffic
    model = zoo.get_model(cfg["model_name"], dict(cfg["model_params"]),
                          training=False,
                          dtype=getattr(torch, cfg["inference_dtype"]),
                          device=ctx.device)
    model.load_state_dict(make_weights(
        common.reference_module(cfg).build(cfg, "meta"), ctx.seed,
        ctx.device))
    h, w = tr["pad_to"] or tr["image_hw"]
    return T.TTAPredictor(model, {"scale_size": cfg["scale_size"],
                                  "dataset_name": cfg["dataset_name"]},
                          tta=tr["tta"],
                          ori_hw=(h, w) if tr["resize"] else None,
                          resize=bool(tr["resize"]))


@contextlib.contextmanager
def captured_metrics():
    """Keep every batch's totals as ``batch_image_metrics`` returns them to
    ``tta_pass`` (the answers the check judges), in a list."""
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    plain = M.batch_image_metrics
    seen: List[Dict[str, torch.Tensor]] = []

    def capture(*args, **kwargs):
        stats = plain(*args, **kwargs)
        seen.append(stats)
        return stats

    M.batch_image_metrics = capture
    try:
        yield seen
    finally:
        M.batch_image_metrics = plain


def timed_passes(ctx: Context, predictor, batches, captured):
    """Passes back to back for ``ctx.seconds``; (images, seconds, the last
    pass's batches, probabilities and totals)."""
    from eyediseasesegmentation_tpu_torch.infer import tta as T

    images, last = 0, None
    t0 = ctx.now()
    deadline = t0 + ctx.seconds
    while ctx.now() < deadline:
        last = None                   # the previous pass's maps go first
        captured.clear()
        seen: List[dict] = []

        def feed():
            for b in batches:
                if ctx.now() >= deadline:
                    return
                seen.append(b)
                yield b

        _, probs, _ = T.tta_pass(predictor, feed(), ctx.traffic["score"])
        images += sum(b["n_valid"] for b in seen)
        last = (seen, probs, list(captured))
    ctx.sync()
    return images, ctx.now() - t0, last


def traced_pass(ctx: Context, predictor, batches, captured):
    """One whole pass untraced, one profiled with device activity alone,
    one with the host's activity and the ranges the cell's metrics declare
    (``devtrace.stretches``; the profiler warmed on one batch); (images,
    the device-only pass's seconds, the last pass's batches, probabilities
    and totals, the trace's figures)."""
    from eyediseasesegmentation_tpu_torch.infer import tta as T
    from perfbench import devtrace
    from perfbench.work import flops

    def one_pass():
        captured.clear()
        t0 = ctx.now()
        with torch.profiler.record_function("pb.pass"):
            _, probs, _ = T.tta_pass(predictor, batches,
                                     ctx.traffic["score"])
        ctx.sync()
        return ctx.now() - t0, probs

    def warm():
        T.tta_pass(predictor, batches[:1], ctx.traffic["score"])
        ctx.sync()

    trace, probs = devtrace.stretches(common.OUT / "trace.json",
                                      ctx.ranges, one_pass, warm)
    images = sum(b["n_valid"] for b in batches)
    views = T.TTA_FAMILIES[ctx.traffic["tta"]][2]
    trace.update(kind="tta", images=images, views=views * images,
                 view_flops=flops.forward_flops(ctx.config,
                                                ctx.config["scale_size"]))
    return images, trace["window_s"], (batches, probs, list(captured)), trace


def run(ctx: Context) -> Result:
    from eyediseasesegmentation_tpu_torch.infer import tta as T

    tr = ctx.traffic
    if ctx.device.type == "cuda":
        from eyediseasesegmentation_tpu_torch.ops import _build
        _build.load_all()
    predictor = build_program(ctx)
    batches = make_batches(ctx)
    trace = None
    with captured_metrics() as captured:
        T.tta_pass(predictor, batches[:int(tr["warm_batches"])], tr["score"])
        ctx.sync()
        setup_s = ctx.now() - ctx.t_start
        ctx.free()
        ctx.reset_peak()
        if ctx.trace:
            images, window, last, trace = traced_pass(ctx, predictor,
                                                      batches, captured)
        else:
            images, window, last = timed_passes(ctx, predictor, batches,
                                                captured)
        peak = ctx.peak_bytes()
    del predictor
    attempted = 3 * images if trace else images
    return Result(e2e={"images_per_s": images / window,
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
                  attempted=attempted, failed=0, checks=check(ctx, last),
                  memory_peak_bytes=peak, trace=trace)


def picks(ctx: Context, n_batches: int) -> List[int]:
    """The checked batches of a pass of ``n_batches``, drawn from the
    seed."""
    k = min(int(ctx.traffic["check_batches"]), n_batches)
    return sorted(int(i) for i in ctx.rng(7).choice(n_batches, k,
                                                    replace=False))


def reference_model(ctx: Context, dtype=torch.float32, control=False):
    """The reference from the benchmark's weights, in ``dtype``; the
    control (``control``): bfloat16 parameters and activations, every
    convolution's and matmul's operands and every module's output in
    float8 e4m3."""
    R = common.reference_module(ctx.config)
    model = R.build(ctx.config, ctx.device)
    model.load_state_dict(make_weights(model, ctx.seed, ctx.device))
    if control:
        R.set_compute(model, R.Compute(fp8=True))
        R.round_outputs_fp8(model)
        dtype = torch.bfloat16
    return model.to(dtype)


def reference_outputs(ctx: Context, model, batch: dict):
    """The reference's probabilities and totals of one host batch."""
    cfg, tr = ctx.config, ctx.traffic
    raw = torch.from_numpy(batch["image"]).to(ctx.device)
    with exact_float32():
        p = RT.predict(model, raw, cfg["scale_size"], cfg["dataset_name"],
                       resize=bool(tr["resize"]))
    masks = torch.from_numpy(batch["mask"]).to(ctx.device)
    return p, RM.batch_totals(p, masks, batch["n_valid"], tr["score"])


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def _logit_gaps(p: torch.Tensor, ref: torch.Tensor):
    """(widest, mean) gap of the logits behind ``p`` and ``ref``, as
    shares of the reference logits' standard deviation."""
    lr = _logit(ref)
    d = (_logit(p) - lr).abs() / lr.std().clamp(min=1e-30)
    return float(d.max()), float(d.mean())


def numbers(rows) -> Dict[str, float]:
    """The numbers compared, over rows of (program probabilities, program
    totals, reference probabilities, reference totals, the reference's
    probabilities computed in bfloat16) of the checked batches.

    ``logit_max_x_bf16`` and ``logit_mean_x_bf16``: the widest and the mean
    gap between the logits behind the program's and the reference's
    probabilities, each over the same gap of the reference computed in
    bfloat16 (the configuration's precision). A seed's random weights set
    how far the network amplifies rounding (the plain gaps move 5× from
    seed to seed on both sides); the ratio takes that out. Also the plain
    gaps (logits as shares of the reference logits' standard deviation,
    probabilities), the mean per-image score gap, the widest sweep-count
    gap as a share of the pixels, and the gap of the counts that do not
    depend on the probabilities (exact)."""
    out = {"logit_rel_max": 0.0, "logit_rel_mean": 0.0, "prob_max": 0.0,
           "prob_mean": 0.0, "score_gap": 0.0, "sweep_gap": 0.0,
           "count_gap": 0.0, "logit_max_x_bf16": 0.0,
           "logit_mean_x_bf16": 0.0}
    for pp, ps, rp, rs, bp in rows:
        lmax, lmean = _logit_gaps(pp, rp)
        bmax, bmean = _logit_gaps(bp, rp)
        d = (pp.float() - rp.float()).abs()
        ps = {k: v.double().cpu() for k, v in ps.items()}
        rs = {k: v.double().cpu() for k, v in rs.items()}
        sweep = max(float((ps[k] - rs[k]).abs().max()) / float(rs["px"])
                    for k in ("tp", "pp", "tn"))
        exact = max(abs(float(ps["ap_count"] - rs["ap_count"])),
                    float((ps["ap"] - rs["ap"]).abs().max()),
                    abs(float(ps["px"] - rs["px"])))
        for k, v in (("logit_rel_max", lmax), ("logit_rel_mean", lmean),
                     ("prob_max", float(d.max())),
                     ("prob_mean", float(d.mean())),
                     ("score_gap", abs(float(ps["ap_sum"] - rs["ap_sum"]))
                      / max(float(rs["ap_count"]), 1.0)),
                     ("sweep_gap", sweep), ("count_gap", exact),
                     ("logit_max_x_bf16", lmax / max(bmax, 1e-30)),
                     ("logit_mean_x_bf16", lmean / max(bmean, 1e-30))):
            out[k] = max(out[k], v)
    return out


def check(ctx: Context, last) -> List[List]:
    """Compare the checked batches of the last pass with the reference,
    once the program is gone from the device."""
    if last is None or not last[0]:
        return common.check_list({}, ctx.limits)
    seen, probs, stats = last
    chosen = picks(ctx, len(seen))
    kept = [(seen[i], probs[i][0], stats[i]) for i in chosen]
    del last, probs, stats
    ctx.free()
    ref = reference_model(ctx)
    half = reference_model(ctx, torch.bfloat16)
    rows = []
    for batch, pp, ps in kept:
        rp, rs = reference_outputs(ctx, ref, batch)
        bp, _ = reference_outputs(ctx, half, batch)
        rows.append((pp, ps, rp, rs, bp))
    return common.check_list(numbers(rows), ctx.limits)
