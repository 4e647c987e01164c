"""The shape of a run's last line, with the look for a card and the loop
stood in for."""

import json
import types

import pytest
import torch

from perfbench import run
from perfbench.common import Result


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")


def stand_in(monkeypatch, checks, trace):
    res = Result(e2e={"images_per_s": 5.5, "peak_mem_gib": 26.0,
                      "setup_s": 30.0, "train_step_ms": 1.0},
                 attempted=54, failed=0, checks=checks,
                 memory_peak_bytes=123, trace=trace)
    mod = types.SimpleNamespace(run=lambda ctx: res)
    monkeypatch.setattr(run.importlib, "import_module", lambda name: mod)


def last_line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_untraced_line(fake_card, monkeypatch, capsys):
    stand_in(monkeypatch, [["prob_max", 0.01, 0.1]], None)
    assert run.main(["--workload", "idrid_tta_d4_b3", "--seed",
                     "2147483999", "--seconds", "1", "--trace", "0"]) == 0
    line, err = last_line(capsys)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "compared"}
    assert list(line)[-1] == "compared"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"images_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["images_per_s"] == {"value": 5.5,
                                               "unit": "images/s"}
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert err.strip().splitlines()[-1] == \
        "compared prob_max 0.01 limit 0.1"


def test_traced_line_and_a_failed_comparison(fake_card, monkeypatch, capsys):
    trace = {"kind": "tta", "busy_s": 9.0, "window_s": 10.0, "images": 27,
             "host_busy_s": 9.0, "host_window_s": 12.0,
             "plain_window_s": 9.5,
             "views": 216, "view_flops": 1e12,
             "families": {"pb.k1": {"kernel_s": 0.1, "aten_calls": 0},
                          "pb.metrics": {"kernel_s": 0.5, "aten_calls": 0}},
             "work": {"pb.k1": [12, 1.0, 1.0, 0.01]},
             "device_ops": [["k", 1.0]], "idle_gaps": [["aten::mul", 0.5]]}
    stand_in(monkeypatch, [["prob_max", 0.2, 0.1]], trace)
    assert run.main(["--workload", "idrid_tta_d4_b3", "--seed", "5",
                     "--seconds", "1", "--trace", "1"]) == 0
    line, _ = last_line(capsys)
    assert line["correct"] is False
    m = line["metrics"]
    assert m["device_idle.tta"]["value"] == pytest.approx(10.0)
    assert m["k1_roofline"]["value"] == pytest.approx(10.0)
    assert m["metrics_ms.tta"]["value"] == pytest.approx(500 / 27)
    assert "k2_roofline" not in m                 # nothing to read
    assert line["device"]["busy_s"] == 9.0
    assert line["breakdown"] == {"device_ops": [["k", 1.0]],
                                 "idle_gaps": [["aten::mul", 0.5]]}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "idrid_tta_d4_b3", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
