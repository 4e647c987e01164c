"""The control comes out not correct under each cell's limits: the
reference put in the program's place one precision below the
configuration's bfloat16 (float8 e4m3 operands and module outputs), at the
oracle size on the CPU. At the cells' sizes on the card the same control
set the limits' upper readings (PERF.md)."""

import pytest
import torch

from perfbench.common import check_list
from perfbench.loops import train as DT
from perfbench.loops import tta as DTTA
from perfbench.tests.helpers import tiny_context


def correct(numbers, limits) -> bool:
    return all(v <= lim for _, v, lim in check_list(numbers, limits))


@pytest.mark.parametrize("cell", ["idrid_tta_d4_b3", "drive_tta_d4_b2"])
def test_tta_control_fails(cell):
    ctx = tiny_context(cell)
    batches = DTTA.make_batches(ctx)
    ref = DTTA.reference_model(ctx)
    half = DTTA.reference_model(ctx, torch.bfloat16)
    ctl = DTTA.reference_model(ctx, control=True)
    rows = []
    for b in batches:
        rp, rs = DTTA.reference_outputs(ctx, ref, b)
        bp, _ = DTTA.reference_outputs(ctx, half, b)
        cp, cs = DTTA.reference_outputs(ctx, ctl, b)
        rows.append((cp, cs, rp, rs, bp))
    assert not correct(DTTA.numbers(rows), ctx.limits)


def test_train_control_fails():
    ctx = tiny_context("idrid_train_b2")
    pool = DT.make_pool(ctx)
    ref = DT.reference_steps(ctx, pool)
    yard = DT.bf16_first_logits(ctx, pool)
    cl, cg, clog, ca, _ = DT.reference_steps(ctx, pool, fp8=True)
    nums = DT.numbers_of(cl, cg, clog, ca, ref, yard)
    assert not correct(nums, ctx.limits), nums
