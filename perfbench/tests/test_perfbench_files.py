"""BENCHMARK.json against the contract's shape, and every file a cell
names found by name."""

import json
import re

import pytest

from perfbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    files = run.cell_files(cell)
    assert files["traffic"]["loop"] in ("tta", "train")
    assert (run.ROOT / "perfbench" / "loops"
            / f"{files['traffic']['loop']}.py").exists()
    assert files["limits"]
    e2e = [m for m in BENCH["end_to_end"] if run.listed(m, cell)]
    assert {"setup_s"} < {m["name"] for m in e2e}
    layer = [m for m in BENCH["per_layer"] if run.listed(m, cell)]
    assert layer
    for m in layer:
        assert callable(run.load_reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


def test_every_config_used_and_layers_named_alike():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_readers_return_nothing_on_an_empty_trace():
    empty = {"kind": "none", "busy_s": 0.0, "window_s": 1.0,
             "families": {}, "work": {}}
    for m in BENCH["per_layer"]:
        assert run.load_reader(m["name"])(empty) is None
