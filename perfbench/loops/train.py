"""Closed-loop training through ``train.trainer.Trainer.train_step``.

The traffic file gives the pool of host images (count, side, mask
density), the steps that are compared with the reference, the steps traced
and the warm-up. The pool is made on the device from the seed and held on
the host as uint8 numpy arrays; batches take its rows in turn, so the
compared steps see rows that all differ.

Set-up builds one ``Trainer`` (the configuration's training spec, the
benchmark's weights), drives its first steps through the same call and
feed as the window, and keeps from them, on the host: each step's loss,
the first gradient as AdamW holds it (its first moment over 1 − β1), and
the parameters and BatchNorm statistics after the compared steps. The same
object then runs the window: steps back to back until the time is up,
synchronised at the end. ``train_step_ms`` is the window's seconds over its
steps.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import common
from perfbench.common import Context, Result, exact_float32, leaf_gaps
from perfbench.reference import train as RTR
from perfbench.weights import make_weights


def make_pool(ctx: Context):
    tr = ctx.traffic
    n, s = int(tr["pool"]), int(ctx.config["scale_size"])
    gen = ctx.device_gen(2)
    dev = ctx.device
    img = torch.randint(0, 256, (n, s, s, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    field = torch.rand((n, 1, s // 32 + 2, s // 32 + 2), generator=gen,
                       device=dev)
    field = F.interpolate(field, size=(s, s), mode="bilinear",
                          align_corners=False)[:, 0]
    mask = (field > float(tr["mask_threshold"])).to(torch.uint8)
    return img.cpu().numpy(), mask.cpu().numpy()


def train_config(config: dict) -> dict:
    keys = ("model_name", "model_params", "scale_size", "dataset_name",
            "lesion_type")
    return {**{k: config[k] for k in keys}, **config["train"],
            "num_workers": 0, "tensorboard": False}


def build_program(ctx: Context):
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    trainer = Trainer(train_config(ctx.config), device=ctx.device,
                      seed=ctx.seed % 2 ** 31)
    trainer.model.load_state_dict(make_weights(
        common.reference_module(ctx.config).build(ctx.config, "meta"),
        ctx.seed, ctx.device))
    return trainer


def batch(pool, step: int, bsz: int):
    n = pool[0].shape[0]
    rows = [(step * bsz + i) % n for i in range(bsz)]
    return pool[0][rows], pool[1][rows]


def run(ctx: Context) -> Result:
    tr = ctx.traffic
    bsz = int(ctx.config["train"]["batch_size"])
    lr = float(ctx.config["train"]["learning_rate"])
    trainer = build_program(ctx)
    pool = make_pool(ctx)
    epoch_gen = torch.Generator().manual_seed(ctx.seed)
    model = trainer.model

    # the compared first steps, through the window's own call and feed
    losses, first_grad, logits = compared_steps(trainer, pool, epoch_gen,
                                                int(tr["compared_steps"]))
    after = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    step = int(tr["compared_steps"])
    for _ in range(int(tr["warm_steps"])):
        trainer.train_step(*batch(pool, step, bsz), epoch_gen, lr)
        step += 1
    ctx.sync()
    setup_s = ctx.now() - ctx.t_start
    ctx.free()
    ctx.reset_peak()

    trace = None
    steps = 0
    if ctx.trace:
        from perfbench import devtrace

        def stretch(n=int(tr["trace_steps"])):
            nonlocal step
            t0 = ctx.now()
            for _ in range(n):
                trainer.train_step(*batch(pool, step, bsz), epoch_gen, lr)
                step += 1
            ctx.sync()
            return ctx.now() - t0, None

        trace, _ = devtrace.stretches(common.OUT / "trace.json",
                                      ctx.ranges, stretch,
                                      lambda: stretch(1))
        steps = int(tr["trace_steps"])
        window = trace["window_s"]
    else:
        t0 = ctx.now()
        deadline = t0 + ctx.seconds
        while ctx.now() < deadline:
            trainer.train_step(*batch(pool, step, bsz), epoch_gen, lr)
            step += 1
            steps += 1
        ctx.sync()
        window = ctx.now() - t0
    peak = ctx.peak_bytes()
    del trainer, model
    ctx.free()

    numbers = compare(ctx, pool, losses, first_grad, logits, after)
    e2e = {"train_step_ms": 1e3 * window / steps,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    if trace is not None:
        from perfbench.work import flops
        trace.update(kind="train", steps=steps, samples=steps * bsz,
                     view_flops=flops.forward_flops(
                         ctx.config, ctx.config["scale_size"]))
    return Result(e2e=e2e, attempted=3 * steps + 1 if trace else steps,
                  failed=0,
                  checks=common.check_list(numbers, ctx.limits),
                  memory_peak_bytes=peak, trace=trace)


def compared_steps(trainer, pool, epoch_gen, n: int):
    """Drive ``trainer``'s first ``n`` steps; return (their losses, the
    first gradient as AdamW holds it (its first moment over 1 − β1), the
    first step's logits as the step's loss took them), on the host."""
    bsz = int(trainer.configs["batch_size"])
    lr = float(trainer.configs["learning_rate"])
    params = dict(trainer.model.named_parameters())
    seen = []
    plain = trainer.compute_loss

    def keep_logits(out, m4):
        total, parts, final = plain(out, m4)
        if not seen:
            seen.append(final.detach().float().cpu())
        return total, parts, final

    trainer.compute_loss = keep_logits
    losses = []
    try:
        for step in range(n):
            out = trainer.train_step(*batch(pool, step, bsz), epoch_gen, lr)
            losses.append(out["loss"])
            if step == 0:
                st = trainer.optimizer.state
                grads = {k: (st[p]["exp_avg"] / (1 - RTR.B1)).detach().cpu()
                         for k, p in params.items()}
    finally:
        del trainer.compute_loss
    return [float(v) for v in losses], grads, seen[0]


def pool_batches(ctx: Context, pool):
    bsz = int(ctx.config["train"]["batch_size"])
    return [tuple(torch.from_numpy(a).to(ctx.device)
                  for a in batch(pool, step, bsz))
            for step in range(int(ctx.traffic["compared_steps"]))]


def reference_steps(ctx: Context, pool, fp8: bool = False,
                    dtype: torch.dtype = torch.float32):
    """(losses, first gradients, first logits, state after the compared
    steps, the initial state) of the reference from the benchmark's
    weights, in ``dtype``; with ``fp8`` the control: bfloat16 parameters,
    activations, gradients and AdamW state, every convolution's and
    matmul's operands and every module's output in float8 e4m3."""
    cfg = ctx.config
    R = common.reference_module(cfg)
    ref = R.build(cfg, ctx.device)
    init = make_weights(ref, ctx.seed, ctx.device)
    ref.load_state_dict(init)
    if fp8:
        R.set_compute(ref, R.Compute(fp8=True))
        R.round_outputs_fp8(ref)
        ref = ref.to(torch.bfloat16)
    else:
        ref = ref.to(dtype)
    opt = RTR.AdamW(ref, float(cfg["train"]["learning_rate"]),
                    float(cfg["train"]["weight_decay"]))
    with exact_float32():
        losses, grads, logits = RTR.train_steps(
            ref, opt, pool_batches(ctx, pool),
            torch.Generator().manual_seed(ctx.seed), cfg["dataset_name"])
    after = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    return losses, grads, logits, after, init


def bf16_first_logits(ctx: Context, pool) -> torch.Tensor:
    """The yardstick: the reference's first train-mode forward in
    bfloat16 (the configuration's precision)."""
    ref = common.reference_module(ctx.config).build(ctx.config, ctx.device)
    ref.load_state_dict(make_weights(ref, ctx.seed, ctx.device))
    ref = ref.to(torch.bfloat16)
    images, masks = pool_batches(ctx, pool)[0]
    return RTR.first_logits(ref, images, masks,
                            torch.Generator().manual_seed(ctx.seed),
                            ctx.config["dataset_name"])


def numbers_of(losses, grads, logits, after, ref, yard) -> Dict[str, float]:
    """The readings of the compared steps against the reference's.

    Compared (the limits file holds these): ``first_logit_mean_x_bf16``,
    the mean gap of the first step's logits over the same gap of the
    reference's forward in bfloat16 (a seed's weights set how far the
    network amplifies rounding; the ratio takes that out);
    ``first_loss_gap``, the first step's relative loss gap; and
    ``update_gap_group_median``, the largest over the optimizer's groups
    (lr × 1, the encoder's lr × 0.1, the position tables) of the median
    leaf's gap of the change's norm over the compared steps; and
    ``stats_gap_median``, the median leaf's gap of the change of the
    BatchNorm running statistics (means and variances) that either side
    moves, the median taken over those statistics alone. Reported beside
    them: the widest logit gap's ratio, every step's loss gap, the first
    gradient's, the change's and the statistics' gaps by the worst and the
    median leaf, and the change's relative distance. A leaf's gap is
    |‖prog‖ − ‖ref‖| over the larger of its reference norm and the median
    leaf's of its set; the parameters whose reference gradient is under a
    thousandth of the median leaf's (rounding alone moves them under Adam)
    are left out; the worst and the median leaf's change take in the
    statistics too."""
    r_losses, r_grads, r_logits, r_after, init = ref
    moved = moved_leaves(r_grads)
    dev = next(iter(r_grads.values())).device
    grads = {n: grads[n].to(dev) for n in moved}
    d_prog, d_ref, stats = changes(after, r_after, init)
    g_worst, g_med = leaf_gaps(grads, r_grads, moved)
    u_worst, u_med = leaf_gaps(d_prog, d_ref, moved + stats)
    s_worst, s_med = leaf_gaps(d_prog, d_ref, stats)
    by_group: Dict[tuple, list] = {}
    for n in moved:
        by_group.setdefault(RTR.group_of(n), []).append(n)
    u_group = max(leaf_gaps(d_prog, d_ref, ns)[1] for ns in by_group.values())
    num = sum(float((d_prog[n] - d_ref[n]).pow(2).sum()) for n in moved)
    den = sum(float(d_ref[n].pow(2).sum()) for n in moved)
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, r_losses)]
    r_logits = r_logits.double()
    gap = (logits.to(dev).double() - r_logits).abs()
    yard_gap = (yard.to(dev).double() - r_logits).abs()
    widest = float(gap.max())
    return {"first_logit_x_bf16": widest / max(float(yard_gap.max()), 1e-30),
            "first_logit_mean_x_bf16": float(gap.mean())
            / max(float(yard_gap.mean()), 1e-30),
            "first_logit_rel_max": widest / float(r_logits.std()),
            "update_gap_group_median": u_group,
            "update_dir": (num / max(den, 1e-300)) ** 0.5,
            "first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": g_worst, "grad_gap_median": g_med,
            "update_gap": u_worst, "update_gap_median": u_med,
            "stats_gap": s_worst, "stats_gap_median": s_med}


def moved_leaves(r_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The parameters whose reference gradient is at least a thousandth
    of the median leaf's."""
    gn = {n: float(g.double().norm()) for n, g in r_grads.items()}
    med = float(np.median(list(gn.values())))
    return [n for n in r_grads if gn[n] >= 1e-3 * med]


def changes(after, r_after, init):
    """(the program's change of every leaf over the compared steps, the
    reference's, the BatchNorm running statistics that either side
    moves), in float64 on the reference's device."""
    dev = next(iter(r_after.values())).device
    d_prog, d_ref = {}, {}
    for k in r_after:
        d_prog[k] = after[k].to(dev).double() - init[k].double()
        d_ref[k] = r_after[k].double() - init[k].double()
    stats = [k for k in r_after if k.endswith(("running_mean", "running_var"))
             and (bool(d_ref[k].any()) or bool(d_prog[k].any()))]
    return d_prog, d_ref, stats


def compare(ctx: Context, pool, losses, grads, logits, after
            ) -> Dict[str, float]:
    ref = reference_steps(ctx, pool)
    yard = bf16_first_logits(ctx, pool)
    return numbers_of(losses, grads, logits, after, ref, yard)
