"""One run of one cell of the port's benchmark.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file ``perfbench/traffic/<traffic>.json``
(whose ``loop`` names a module of ``perfbench/loops/``), the limits of
its compared numbers ``perfbench/limits/<cell>.json`` and one module
``perfbench/layer_metrics/<metric>.py`` per per-layer metric (its ``read``,
and the ``RANGES`` it reads, which a traced run installs). The run sets
up, warms up on the cell's shapes, measures for ``--seconds`` (or, with
``--trace 1``, traces one stretch), compares what the timed path produced
with the plain reference, prints each compared number beside its limit on
standard error, and prints one JSON line last on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eyediseasesegmentation_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_metric(name: str):
    """The module ``perfbench/layer_metrics/<name>.py``."""
    path = ROOT / "perfbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return load_metric(name).read


def cell_ranges(bench: dict, cell: str) -> list:
    """The ranges that the cell's per-layer metrics declare, each name
    once."""
    out = {}
    for m in bench["per_layer"]:
        if listed(m, cell):
            for spec in getattr(load_metric(m["name"]), "RANGES", []):
                out.setdefault(spec["name"], spec)
    return list(out.values())


def cell_files(workload: str) -> dict:
    """The cell's entry, its configuration entry and the contents of its
    configuration, traffic and limits files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "bench": bench, "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((ROOT / "perfbench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((ROOT / "perfbench" / "limits"
                              / f"{workload}.json").read_text()),
    }


def listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    files = cell_files(args.workload)
    cell = files["cell"]
    # the program's caches stay inside the checkout, at fixed paths
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    from perfbench.common import Context

    traffic = files["traffic"]
    loop = importlib.import_module(f"perfbench.loops.{traffic['loop']}")
    ctx = Context(config=files["config"], traffic=traffic,
                  limits=files["limits"], seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), t_start=T_START,
                  ranges=cell_ranges(files["bench"], cell["name"])
                  if args.trace else [])
    res = loop.run(ctx)

    bench = files["bench"]
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if not listed(m, cell["name"]):
                continue
            value = load_reader(m["name"])(res.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if listed(m, cell["name"]) and m["name"] in res.e2e:
                metrics[m["name"]] = {"value": res.e2e[m["name"]],
                                      "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    correct = all(v <= lim for _, v, lim in res.checks) and res.failed == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = res.trace["busy_s"]
        device["window_s"] = res.trace["window_s"]
        line["breakdown"] = {"device_ops": res.trace["device_ops"],
                             "idle_gaps": res.trace["idle_gaps"]}
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in res.checks}
    # which kernel routes ran (the port's launch counters)
    for name in ("axial_attention", "scse_conv", "decode_pair", "conv"):
        mod = sys.modules.get(f"eyediseasesegmentation_tpu_torch.ops.{name}")
        if mod is not None:
            print(f"launches {name}: {mod.launches} (sm90 "
                  f"{mod.launches_sm90}, wmma {mod.launches_wmma})",
                  file=sys.stderr)
    if args.trace:
        t = res.trace
        print(f"traced: untraced stretch {t['plain_window_s']!r} s; "
              f"device-only stretch {t['window_s']!r} s, busy "
              f"{t['busy_s']!r} s; host-profiled stretch "
              f"{t['host_window_s']!r} s, busy {t['host_busy_s']!r} s",
              file=sys.stderr)
    for n, v, lim in res.checks:
        print(f"compared {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
