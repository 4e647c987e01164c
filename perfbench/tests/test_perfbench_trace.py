"""The ranges the per-layer metrics declare, and a traced run of each
loop on the CPU at the oracle size (the two stretches, the ranges
installed from the metrics' files and taken off again)."""

import json

import pytest

from perfbench import devtrace, run
from perfbench.loops import train as DT
from perfbench.loops import tta as DTTA
from perfbench.tests.helpers import tiny_context

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_declared_ranges_resolve(cell):
    specs = run.cell_ranges(BENCH, cell)
    assert len({s["name"] for s in specs}) == len(specs)
    for spec in specs:
        owner, attr = devtrace.resolve(spec["call"])
        assert callable(getattr(owner, attr)), spec["call"]


def test_installed_ranges_count_work_and_come_off():
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    plain = M.dice_coeff
    spec = {"name": "pb.test",
            "call": "eyediseasesegmentation_tpu_torch.ops.metrics:"
                    "dice_coeff",
            "work": lambda *a, **k: (10.0, 20.0)}
    import torch
    x = torch.rand(4, 4)
    with devtrace.installed([spec]) as ranges:
        assert M.dice_coeff is not plain
        assert float(M.dice_coeff(x, x > 0.5)) == float(plain(x, x > 0.5))
    assert M.dice_coeff is plain
    assert ranges.work["pb.test"][:3] == [1, 10.0, 20.0]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_cpu(cell):
    ctx = tiny_context(cell, trace=True)
    ctx.ranges = run.cell_ranges(BENCH, cell)
    loop = DTTA if run.cell_files(cell)["traffic"]["loop"] == "tta" else DT
    res = loop.run(ctx)
    tr = res.trace
    assert tr["window_s"] > 0 and tr["host_window_s"] > 0
    names = {s["name"] for s in ctx.ranges}
    assert set(tr["families"]) == names
    entry = "pb.metrics" if loop is DTTA else "pb.step"
    assert tr["work"][entry][0] > 0            # its calls were counted
    assert tr["families"][entry]["aten_calls"] > 0
    for spec in ctx.ranges:                     # every wrap came off
        owner, attr = devtrace.resolve(spec["call"])
        assert getattr(owner, attr).__name__ != "wrapped"
