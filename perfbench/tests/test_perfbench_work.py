"""The FLOP, byte and roofline arithmetic against hand counts, and the
trace reduction on a trace written by hand."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import devtrace
from perfbench.reference import model as R
from perfbench.work import kernels, peaks


def test_flop_counter_counts_a_conv_and_a_matmul_by_hand():
    conv = torch.nn.Conv2d(8, 16, 3, bias=False, device="meta")
    x = torch.empty((2, 8, 10, 12), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        R.conv(R.Compute(), x, conv, 1, 1)
        torch.empty((5, 7), device="meta") @ torch.empty((7, 3),
                                                         device="meta")
    assert counter.get_total_flops() == 2 * 2 * 10 * 12 * 16 * 8 * 9 \
        + 2 * 5 * 7 * 3


def test_k1_work_by_hand():
    b, L, c, H, dkq, dv = 3, 4, 16, 2, 8, 8
    x = torch.empty((b, L, c))
    f, n = kernels.k1_work(x, x, None, H, dkq, dv, torch.bfloat16)
    nkq = H * (2 * dkq + dv)
    assert f == 2 * b * L * c * nkq + 2 * b * H * L * L * (3 * dkq + 2 * dv)
    assert n == 2 * (b * L * c + c * nkq + b * L * H * dv + dv * L * L) \
        + 4 * 2 * dkq * L * L
    xv = torch.empty((b, L, 4))
    f2, n2 = kernels.k1_work(x, xv, object(), H, dkq, 2, torch.float32)
    assert f2 == (2 * b * L * c * H * 2 * dkq + 2 * b * L * 4 * H * 2
                  + 2 * b * H * L * L * (3 * dkq + 4))


def test_k2_work_by_hand():
    parts = [torch.empty((2, 4, 3, 10), dtype=torch.bfloat16),
             torch.empty((2, 6, 6, 10), dtype=torch.bfloat16)]
    f, n = kernels.k2_work(parts, 5, True, torch.bfloat16)
    px = 2 * 6 * 10
    assert f == (2 * 9 * 10 * 5 + 30) * px + 2 * 9 * 25 * px
    assert n == 2 * (2 * 4 * 3 * 10 + 2 * 6 * 6 * 10 + 9 * 10 * 5 + px * 5
                     + 9 * 25) + 4 * 2 * 10 + 4 * 2 * 5


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_reduce_trace_by_hand(tmp_path):
    ev = [
        # host: one range with two aten calls (the second nests one)
        {"ph": "X", "cat": "user_annotation", "name": "pb.k1", "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 5,
         "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 20,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn", "ts": 25,
         "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150,
         "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 160, "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 110, "dur": 40,
         "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 170, "dur": 20,
         "tid": 7, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 140,
         "dur": 20, "tid": 7},
    ]
    f = tmp_path / "t.json"
    f.write_text(json.dumps({"traceEvents": ev}))
    s = devtrace.reduce_trace(f, 1e-3, ["pb.k1"])
    assert s["busy_s"] == pytest.approx(70e-6)      # 110-160 ∪ 170-190
    assert s["families"]["pb.k1"]["kernel_s"] == pytest.approx(40e-6)
    assert s["families"]["pb.k1"]["aten_calls"] == 2
    assert s["device_ops"][0] == ["k_a", pytest.approx(40e-6)]
    assert s["idle_gaps"] == [["aten::add", pytest.approx(10e-6)]]
