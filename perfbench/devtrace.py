"""The traced stretch: ``torch.profiler`` driven from the benchmark's own
files, named ranges around the calls into the program's layers, and the
reduction of the device trace to what the per-layer readers take.

A per-layer metric's module declares the ranges it reads (``RANGES``: a
range's ``name``, the ``call`` it wraps as ``module:attribute`` or
``module:Class.method``, and optionally a ``work`` function of the call's
arguments that gives its operations and bytes). A range is opened by
wrapping that attribute of the program (the function the program looks up
when it calls into a layer) for the length of the traced stretch only. Its
kernels are those whose launch happened inside it on the same host thread
(matched by the trace's correlation ids), so a kernel launched through
ctypes counts as well as one launched by aten.

A traced run runs its stretch three times (``stretches``): untraced, for
the whole step's rate on the host clock; profiled with device activity
alone, after a short warm-up of the profiler, so that the host keeps close
to its untraced pace (the busy time, the window and the top device
operations); then profiled with host activity and the ranges installed
(each range's kernel time, aten calls and work, and the idle gaps by the
host op open at each).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench.work import peaks

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve(call: str):
    """(owner, attribute) of ``module:attribute`` or
    ``module:Class.method``."""
    mod, _, path = call.partition(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Ranges:
    """Named ranges opened around wrapped calls, with the work each call
    carries (from a work function of the call's arguments)."""

    def __init__(self):
        # name → [calls, FLOPs, bytes, Σ per-call bound seconds]
        self.work: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0, 0.0])
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, name: str,
             work: Optional[Callable] = None) -> None:
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            acc = self.work[name]
            acc[0] += 1
            if work is not None:
                f, b = work(*args, **kwargs)
                acc[1] += f
                acc[2] += b
                acc[3] += peaks.bound_s(f, b)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, fn))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


@contextlib.contextmanager
def installed(specs: List[dict]):
    """The ranges of ``specs`` (a metric module's ``RANGES`` entries)
    wrapped around their calls for the block."""
    ranges = Ranges()
    try:
        for spec in specs:
            owner, attr = resolve(spec["call"])
            ranges.wrap(owner, attr, spec["name"], spec.get("work"))
        yield ranges
    finally:
        ranges.restore()


@contextlib.contextmanager
def traced(out_file: Optional[Path], host: bool = True):
    """Profile the device's activity of the block, and with ``host`` (or
    where there is no device) the host's too; the trace lands in
    ``out_file`` (one file, replaced on every traced stretch; none without
    a file)."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if out_file is not None:
            out_file.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out_file))


def stretches(out_file: Path, specs: List[dict],
              stretch: Callable[[], tuple], warm: Callable[[], None]):
    """Run ``stretch`` (which returns its host-clock seconds and a payload)
    three times: untraced; under the profiler with device activity alone,
    after ``warm`` (a little of the same work) has run under it once; then
    with host activity and the ranges of ``specs``. Returns the trace's
    figures (``plain_window_s`` from the first; the device's from the
    second; the ranges' and the idle gaps' from the third, whose own window
    and busy time are kept as ``host_window_s`` and ``host_busy_s``) and
    the third stretch's payload."""
    plain_window, _ = stretch()
    with traced(None, host=False):
        warm()
    with traced(out_file, host=False):
        window, _ = stretch()
    dev = reduce_trace(out_file, window, [])
    with installed(specs) as ranges:
        with traced(out_file, host=True):
            host_window, payload = stretch()
        work = {k: list(v) for k, v in ranges.work.items()}
    host = reduce_trace(out_file, host_window, [s["name"] for s in specs])
    return {"plain_window_s": plain_window, "busy_s": dev["busy_s"],
            "window_s": window, "device_ops": dev["device_ops"],
            "families": host["families"], "idle_gaps": host["idle_gaps"],
            "work": work, "host_window_s": host_window,
            "host_busy_s": host["busy_s"]}, payload


def _union(intervals):
    """Merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(trace_file: Path, window_s: float,
                 families: List[str]) -> dict:
    """Per-layer raw figures of a trace: device busy seconds, each range
    family's count, kernel seconds and outermost aten calls, the top
    device operations and the longest idle gaps by the host op open at
    their start."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    dev, launches, annots, cpu_ops = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat.startswith("cuda_"):          # runtime and API calls
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["ts"], e["tid"])
        elif cat == "user_annotation":
            annots.append(e)
        elif cat == "cpu_op":
            cpu_ops.append(e)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)

    # each family's ranges, per host thread, sorted by start
    fam_ranges: Dict[str, Dict] = {f: defaultdict(list) for f in families}
    for a in annots:
        if a["name"] in fam_ranges:
            fam_ranges[a["name"]][a["tid"]].append((a["ts"],
                                                     a["ts"] + a["dur"]))
    for f in fam_ranges.values():
        for v in f.values():
            v.sort()

    def inside(ranges_by_tid, ts, tid) -> bool:
        rs = ranges_by_tid.get(tid)
        if not rs:
            return False
        i = bisect.bisect_right(rs, (ts, float("inf"))) - 1
        return i >= 0 and rs[i][0] <= ts <= rs[i][1]

    fam = {f: {"kernel_s": 0.0, "aten_calls": 0} for f in families}
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for f in families:
            if inside(fam_ranges[f], launch[0], launch[1]):
                fam[f]["kernel_s"] += e["dur"] * 1e-6

    # outermost aten calls inside each family's ranges
    cpu_ops.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    open_end: Dict[int, float] = {}
    for e in cpu_ops:
        if not e["name"].startswith("aten::"):
            continue
        if e["ts"] < open_end.get(e["tid"], -1.0):
            continue                              # nested in an aten call
        open_end[e["tid"]] = e["ts"] + e["dur"]
        for f in families:
            if inside(fam_ranges[f], e["ts"], e["tid"]):
                fam[f]["aten_calls"] += 1

    # idle gaps between device work, named by the innermost host op open
    # at the gap's start on the busiest host thread
    gaps = []
    if busy:
        threads = defaultdict(int)
        for e in cpu_ops:
            threads[e["tid"]] += 1
        main = max(threads, key=threads.get) if threads else None
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in cpu_ops + annots if e["tid"] == main),
                      key=lambda r: (r[0], -r[1]))
        by_label: Dict[str, float] = defaultdict(float)
        stack: List = []
        k = 0
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            while k < len(host) and host[k][0] <= e0:
                while stack and stack[-1][1] < host[k][0]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < e0:
                stack.pop()
            label = stack[-1][2] if stack else "host: no op open"
            by_label[label] += (s1 - e0) * 1e-6
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "families": fam, "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}
