"""Build the hand-written CUDA kernels and bind them with ctypes.

Each source in ``csrc/`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (sm_90a) into ``build/kernels/`` at the repository root,
on first use in a process. The library's name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a built one is reused. :func:`load_all` starts one ``nvcc`` per
source at the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

def refuse_autograd(name: str, *inputs) -> None:
    """Raise when a kernel wrapper would have to be differentiated: the
    kernels have no backward, so under grad mode an input that requires
    grad would come back as a tensor with no ``grad_fn`` and silently cut
    the graph. Checked on every device, before any library is loaded."""
    if not torch.is_grad_enabled():
        return
    stack = list(inputs)
    while stack:
        t = stack.pop()
        if isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{name}: an input requires grad, but the kernel has no "
                "backward; call it under torch.no_grad() / "
                "torch.inference_mode() (a model in eval mode), or take the "
                "train path")


CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# library name -> (source file, {C function: argtypes}); every function
# returns the cudaError_t of its launch (decode_pair_tiles: a tile count)
_KERNELS = {
    "axial_attention": ("axial_attention.cu", {
        "axial_attention_fwd": [_I] + [_P] * 19 + [_I] * 12 + [_P],
        "axial_attention_sm90_scratch": [_I] * 6,
        "axial_attention_sm90_fwd": [_P] * 17 + [_I] * 7 + [_P],
    }),
    "conv3x3": ("conv3x3.cu", {
        "conv3x3_fwd": [_I, _I] + [_P] * 5 + [_I] * 7 + [_P],
    }),
    "scse_conv": ("scse_conv.cu", {
        "scse_conv3x3_fwd": [_I, _I, _I, _PP, _IP] + [_P] * 8 + [_I] * 7
                            + [_P],
    }),
    "decode_pair": ("decode_pair.cu", {
        "decode_pair_tiles": [_I, _I, _I],
        "decode_pair_fwd": ([_I, _I, _I, _PP, _IP, _I] + [_P] * 14 + [_I] * 7
                            + [_P]),
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# library name -> {"seconds": build time or 0.0 if reused, "log": nvcc output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_all(names=None) -> None:
    """Build and load several libraries, one ``nvcc`` per source, all
    started together (the builds are independent processes)."""
    from concurrent.futures import ThreadPoolExecutor
    names = list(_KERNELS) if names is None else list(names)
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load, names))


def load(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library ``name``."""
    if name in _loaded:
        return _loaded[name]
    source, functions = _KERNELS[name]
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o",
                               str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in functions.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    build_info[name] = {"seconds": seconds, "log": log}
    return lib
