"""Profiling and numerics-debugging hooks (torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/profiling.py``: the
reference's observability switches (``torch.autograd.set_detect_anomaly``,
train.py:161; Catalyst's ``timeit``) become ``debug_nans`` (an error at the
first op that makes a NaN, as ``jax_debug_nans``) and ``StepTimer``; and
``trace`` wraps ``torch.profiler`` so that any region can be captured as a
Chrome trace (CPU activity, and the card's kernels when there is one).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(logdir: Union[str, Path] = "eds_trace"):
    """Profile the enclosed region with ``torch.profiler`` (CPU, and CUDA
    when a device is present) and write its Chrome trace to
    ``<logdir>/trace_<time ns>.json``. Yields the profiler, whose
    ``key_averages()`` give the time by op."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta"
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` at the first op in the enclosed region
    whose floating-point output holds a NaN (the role of
    ``jax_debug_nans``; opt-in, as every op then waits for its check). Off
    again after the block."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


class StepTimer:
    """Rolling per-step timing (the Catalyst `timeit` role)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.times = self.times[-self.window:]
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def rate(self, items_per_step: int = 1) -> float:
        return items_per_step / self.mean if self.mean else 0.0
