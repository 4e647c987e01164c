"""What every loop shares: the run's context, the device clock, the
float32 reference's precision settings and the numbers compared."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "perfbench"


@dataclasses.dataclass
class Context:
    """One run: the configuration and traffic files' contents, the cell's
    limits, the seed, the window's seconds, whether to trace, the device,
    the host clock's reading at the process's start, and the ranges that
    the cell's per-layer metrics declare (installed in a traced run)."""

    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    ranges: List[dict] = dataclasses.field(default_factory=list)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def rng(self, salt: int) -> np.random.Generator:
        """A host generator of this seed (and a salt per use)."""
        return np.random.default_rng([self.seed, salt])

    def device_gen(self, salt: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1000003 + salt) % 2 ** 63)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_module(config: dict):
    """The plain reference's model module that the configuration names
    under ``reference`` (a file under ``perfbench/``, as a path from the
    checkout's root). It gives ``build(config, device)`` (the model in eval
    mode, float32), ``Compute``, ``set_compute`` and
    ``round_outputs_fp8`` (the control's precision)."""
    rel = Path(config["reference"]).with_suffix("")
    return importlib.import_module(".".join(rel.parts))


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions (the reference's float32)."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


@dataclasses.dataclass
class Result:
    """What a loop hands back: end-to-end values by metric name, the
    traced stretch's raw figures (``--trace 1``), the numbers compared with
    their limits, and the counts of work attempted and failed."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[List]
    memory_peak_bytes: int
    trace: Optional[dict] = None


def check_list(numbers: Dict[str, float], limits: Dict[str, float]
               ) -> List[List]:
    """[name, value, limit] for every limit; a number that is missing or
    not finite reads as infinite."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        v = float(v) if v is not None and math.isfinite(float(v)) \
            else math.inf
        out.append([name, v, float(limit)])
    return out


def per_leaf_gaps(prog: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor],
                  names: List[str]) -> Dict[str, float]:
    """name → |‖prog‖ − ‖ref‖| over the larger of the leaf's reference
    norm and the median leaf's, over the leaves ``names``."""
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values()))) if names else 0.0
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: List[str]):
    """(worst, median) over the leaves ``names`` of ``per_leaf_gaps``."""
    if not names:
        return 0.0, 0.0
    gaps = list(per_leaf_gaps(prog, ref, names).values())
    return max(gaps), float(np.median(gaps))
