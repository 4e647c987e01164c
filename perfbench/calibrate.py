"""Readings that the limits of the compared numbers are set from.

    python3 perfbench/calibrate.py --workload NAME --seeds S1 S2 ...
        [--control-seeds N] [--fault FAULT] [--witness fp32|fp64]

For each seed, in one process and at the cell's own sizes: the program's
numbers (its timed path on the batches or steps a run compares, against
the float32 reference) and, for the first ``--control-seeds`` seeds, the
control's (the reference put in the program's place and computed one
precision below the configuration's bfloat16: inference with bfloat16
parameters and activations, every convolution's and matmul's operands and
every module's output in float8 e4m3; training the same, AdamW's state
in bfloat16 too), against the same float32 reference. A test cell also
reads each fault of ``METRIC_FAULTS`` planted in the program's metrics
(the checked batches' pass run again with the fault). A train cell reads,
with ``--fault``, the program with that fault planted in its train step,
and with ``--witness`` a second witness in the program's place: the
program in float32 with TF32 off (``fp32``), or the float32 reference
against a float64 reference (``fp64``). Train readings name the three
BatchNorm statistics with the widest gaps. One JSON line per seed and side
on standard output. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import common  # noqa: E402
from perfbench.common import Context  # noqa: E402
from perfbench.run import cell_files  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402


def metric_fault(name: str):
    """(owner, attribute, replacement) patches that plant the fault
    ``name`` in the program's metrics (``ops.metrics``): the scores ranked
    in the wrong order, the tie blocks dropped (each pixel its own block:
    no ``cummin``), or each threshold's counts taken at the threshold
    below it."""
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    if name == "score_order_flipped":
        plain = M._sorted
        return [(M, "_sorted", lambda scores, labels, descending:
                 plain(scores, labels, not descending))]
    if name == "ties_dropped":
        return [(M, "_block_end_index", lambda boundary: torch.arange(
            boundary.shape[0], device=boundary.device))]
    if name == "sweep_shifted":
        plain = M.threshold_sweep

        def shifted(probs, targets, thresholds=None, valid_mask=None):
            th = M._thresholds(thresholds, probs.device)
            return plain(probs, targets, torch.cat([th[:1], th[:-1]]),
                         valid_mask)

        return [(M, "threshold_sweep", shifted)]
    raise ValueError(name)


METRIC_FAULTS = ("score_order_flipped", "ties_dropped", "sweep_shifted")


@contextlib.contextmanager
def planted(patches):
    keep = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, f in patches:
        setattr(o, a, f)
    try:
        yield
    finally:
        for o, a, f in keep:
            setattr(o, a, f)


def tta_readings(ctx, control: bool, state: dict):
    from eyediseasesegmentation_tpu_torch.infer import tta as T
    from perfbench.loops import tta as D

    tr = ctx.traffic
    if "predictor" not in state:
        state["predictor"] = D.build_program(ctx)
    pred = state["predictor"]
    pred.model.load_state_dict(make_weights(
        common.reference_module(ctx.config).build(ctx.config, "meta"),
        ctx.seed, ctx.device))
    batches = D.make_batches(ctx)
    chosen = [batches[i] for i in D.picks(ctx, len(batches))]

    def program():
        with D.captured_metrics() as captured:
            _, probs, _ = T.tta_pass(pred, chosen, tr["score"])
        return [p[0] for p in probs], list(captured)

    sides = {"program": program()}
    for name in METRIC_FAULTS:
        with planted(metric_fault(name)):
            sides[name] = program()
    ref = D.reference_model(ctx)
    refs = [D.reference_outputs(ctx, ref, b) for b in chosen]
    del ref
    half = D.reference_model(ctx, torch.bfloat16)
    halves = [D.reference_outputs(ctx, half, b)[0] for b in chosen]
    del half
    if control:
        ctl = D.reference_model(ctx, control=True)
        cout = [D.reference_outputs(ctx, ctl, b) for b in chosen]
        del ctl
        sides["control"] = ([p for p, _ in cout], [s for _, s in cout])
    out = {side: D.numbers([(p, s, rp, rs, bp) for p, s, (rp, rs), bp
                            in zip(probs, stats, refs, halves)])
           for side, (probs, stats) in sides.items()}
    del sides, refs, halves
    ctx.free()
    return out


FAULTS = ("half_batch_loss", "loss_altered", "stats_frozen")


def plant(trainer, fault: str):
    """A fault in the program's train step: the loss over half the batch,
    the loss scaled by 1.05 where it is produced, or the BatchNorm running
    statistics left where they are (momentum 1 in flax's sense). Returns
    the undo."""
    if fault == "stats_frozen":
        norms = [m for m in trainer.model.modules()
                 if hasattr(m, "running_mean") and hasattr(m, "momentum")]
        keep = [m.momentum for m in norms]
        for m in norms:
            m.momentum = 1.0

        def undo():
            for m, k in zip(norms, keep):
                m.momentum = k
        return undo
    plain = type(trainer).compute_loss

    def faulty(out, m4):
        if fault == "half_batch_loss":
            n = m4.shape[0] // 2
            return plain(trainer, out[:n] if not isinstance(out, tuple)
                         else out, m4[:n])
        total, parts, final = plain(trainer, out, m4)
        return total * 1.05, parts, final

    trainer.compute_loss = faulty
    return lambda: trainer.__dict__.pop("compute_loss", None)


def widest_stats(after, ref, k: int = 3):
    """The ``k`` BatchNorm statistics with the widest gaps of the change,
    as [name, gap]."""
    from perfbench.loops import train as D

    d_prog, d_ref, stats = D.changes(after, ref[3], ref[4])
    gaps = common.per_leaf_gaps(d_prog, d_ref, stats)
    return [[n, gaps[n]] for n in sorted(gaps, key=gaps.get)[::-1][:k]]


def train_readings(ctx, control: bool, state: dict, fault=None,
                   witness=None):
    from perfbench.loops import train as D

    pool = state["pool"]
    ref = D.reference_steps(ctx, pool)
    yard = D.bf16_first_logits(ctx, pool)
    if witness == "fp64":
        losses, grads, logits, after, _ = ref
        ref = D.reference_steps(ctx, pool, dtype=torch.float64)
    else:
        if "trainer" not in state:
            state["trainer"] = D.build_program(ctx)
        trainer = state["trainer"]
        # a fresh start of the same object: this seed's weights, no
        # optimizer state, step 0
        trainer.model.load_state_dict(make_weights(
            common.reference_module(ctx.config).build(ctx.config, "meta"),
            ctx.seed, ctx.device))
        trainer.optimizer.state.clear()
        trainer.step = 0
        undo = plant(trainer, fault) if fault else (lambda: None)
        try:
            with (common.exact_float32() if witness == "fp32"
                  else contextlib.nullcontext()):
                losses, grads, logits = D.compared_steps(
                    trainer, pool, torch.Generator().manual_seed(ctx.seed),
                    int(ctx.traffic["compared_steps"]))
        finally:
            undo()
        after = {k: v.detach().clone()
                 for k, v in trainer.model.state_dict().items()}
    side = witness or fault or "program"
    res = {side: {**D.numbers_of(losses, grads, logits, after, ref, yard),
                  "stats_widest": widest_stats(after, ref)}}
    del grads, after
    ctx.free()
    if control:
        cl, cg, clog, ca, _ = D.reference_steps(ctx, pool, fp8=True)
        res["control"] = {**D.numbers_of(cl, cg, clog, ca, ref, yard),
                          "stats_widest": widest_stats(ca, ref)}
    ctx.free()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="plant a fault in the program's train step")
    ap.add_argument("--witness", choices=("fp32", "fp64"), default=None,
                    help="a second witness in the program's place (train)")
    args = ap.parse_args()

    files = cell_files(args.workload)
    config = files["config"]
    if args.witness == "fp32":
        config = json.loads(json.dumps(config))
        config["train"]["is_fp16"] = False
    state: dict = {}
    for i, seed in enumerate(args.seeds):
        ctx = Context(config=config, traffic=files["traffic"],
                      limits=files["limits"], seed=seed, seconds=0.0,
                      trace=False, device=torch.device("cuda", 0),
                      t_start=time.perf_counter())
        t0 = time.perf_counter()
        if files["traffic"]["loop"] == "tta":
            res = tta_readings(ctx, i < args.control_seeds, state)
        else:
            from perfbench.loops import train as D
            state["pool"] = D.make_pool(ctx)
            res = train_readings(ctx, i < args.control_seeds, state,
                                 args.fault, args.witness)
        for side, nums in res.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **nums,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
