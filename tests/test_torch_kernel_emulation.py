"""The port's decode-node CUDA kernels, rehearsed on the CPU.

A CUDA kernel has no interpret mode, so ``tests/test_torch_kernels.py`` needs
a GPU. This file compiles the same sources (``csrc/conv3x3.cu``,
``scse_conv.cu``, ``decode_pair.cu`` over ``decode_conv.cuh``,
``conv_sm90.cuh`` and ``sm90.cuh``) with g++ against the stand-in headers of
``tests/torch_cuda_emulation/`` (a std::thread per CUDA thread, a
std::barrier for ``__syncthreads``, wmma done by lane 0 with its alignment
rules asserted; for the sm90 kernel, mbarriers under a lock, a TMA that
copies and swizzles the box, and wgmma that reads its operands back through
their descriptors) and drives the library through the ops' own marshalling
(``_run``) on CPU tensors, against the plain versions. It checks the kernels' index arithmetic, masking, staging and
rounding points at small shapes with several tiles, chunks and parts (the
sm90 body's gated, half-height and channel-sum paths at W = 72, a partial
tile, with its edge boxes); it says nothing of what nvcc accepts, of speed,
or of the memory model.
Tolerances: 1e-5 of max|ref| in fp32 (another order of summation), 2e-2 in
bf16 (single roundings that fall the other way), 1e-4 / 2e-2 for the pair
kernel's channel sums. Skips without g++ (C++20). Imports no JAX.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch.ops import _build
from eyediseasesegmentation_tpu_torch.ops import conv as CK
from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

EMU = Path(__file__).resolve().parent / "torch_cuda_emulation"
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# (part channels, cout, B, H, W): three chunks over three parts on one tile;
# several tiles with ragged edges; odd width and cout (scalar gate loads);
# 64 output channels; more than 64 (two passes; the pair's wmma variant
# keeps y1 in device memory there)
SHAPES = {
    "chunks": ([40, 30, 7], 16, 1, 8, 34),
    "tiles": ([24, 8], 8, 2, 16, 40),
    "odd": ([5, 6], 12, 1, 6, 38),
    "cout64": ([40], 64, 1, 10, 32),
    "wide": ([8, 8], 100, 1, 8, 33),
}
# for the pair alone: parts of 16-channel multiples, W = 72 and odd H (even
# under up_part0), which take the sm90 variant in bf16; with cout 100, two
# passes of 64 output channels with their channel sums
PAIR_SHAPES = {"sm90_parts": ([32, 16], 24, 1, 9, 72),
               "sm90_wide": ([32, 16], 100, 1, 9, 72)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("emu") / "libdecode_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", f"-I{EMU}", f"-I{_build.CSRC}", "-o",
         str(out), str(EMU / "decode_kernels.cpp")],
        capture_output=True, text=True)
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("g++ does not know -std=c++20")
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for name in ("conv3x3", "scse_conv", "decode_pair"):
        for fn, argtypes in _build._KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _inputs(shape, dtype, up0=False, seed=1):
    chs, cout, B, H, W = {**SHAPES, **PAIR_SHAPES}[shape]
    H += H % 2 if up0 else 0
    W += W % 2 if up0 else 0
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    parts = [arr(B, c, H, W).to(dtype) for c in chs]
    if up0:
        parts[0] = torch.nn.functional.interpolate(
            arr(B, chs[0], H // 2, W // 2), scale_factor=(1, 2),
            mode="bilinear", align_corners=False).to(dtype)
    C = sum(chs)
    gate = (parts, torch.sigmoid(arr(B, C)), arr(C, scale=0.3), arr(1)[0])
    conv1 = (arr(cout, C, 3, 3, scale=0.1), arr(cout), arr(cout))
    conv2 = (arr(cout, cout, 3, 3, scale=0.1), arr(cout, scale=0.5) + 1,
             arr(cout, scale=0.1))
    return gate, conv1, conv2


def _variant(parts):
    return SK.variant(parts[0].dtype, parts[0].shape[3],
                      [p.data_ptr() for p in parts],
                      [p.shape[1] for p in parts])


def _close(got, ref, tol):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("gated,relu", [(True, True), (False, False)],
                         ids=["gated", "ungated_linear"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_scse_conv_matches_plain(lib, shape, gated, relu, dtype):
    gate, conv1, _ = _inputs(shape, getattr(torch, dtype))
    rc, got, var = SK._run(lib, None, *gate, *conv1, relu, gated)
    assert rc == 0 and var == _variant(gate[0])
    ref = SK.scse_conv3x3_bn_relu_reference(*gate, *conv1, relu, gated)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    _close(got, ref, TOL[dtype][0])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_conv3x3_matches_plain(lib, shape, dtype):
    gate, conv1, _ = _inputs(shape, getattr(torch, dtype), seed=2)
    x = torch.cat(gate[0], 1)
    rc, got, var = CK._run(lib, None, x, *conv1, True)
    assert rc == 0
    assert var == CK.variant(x.dtype, x.shape[3], x.data_ptr())
    _close(got, CK.conv3x3_bn_relu_reference(x, *conv1, True), TOL[dtype][0])


# (part channels, cout, B, H, W) for the sm90 body alone. K4 on one part:
# one and two tiles across, three 16-channel chunks, two passes of 64 output
# channels, a ragged bottom edge, B = 2; a C that is not a multiple of 16
# (the TMA's zero fill), cout below 16, one chunk. K3 on two parts (the gated
# producer and its edge boxes): odd H, W = 72 (a partial second tile)
SM90_SHAPES = {
    "w64": ([96], 80, 1, 11, 64),
    "w72": ([96], 80, 1, 11, 72),
    "c_tail": ([20], 8, 2, 9, 16),
    "scse_gated": ([32, 16], 24, 1, 9, 72),
}


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape", list(SM90_SHAPES))
def test_emulated_conv3x3_sm90_matches_plain(lib, shape, relu):
    chs, cout, B, H, W = SM90_SHAPES[shape]
    rng = np.random.RandomState(4)

    def arr(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    parts = [arr(B, c, H, W).to(torch.bfloat16) for c in chs]
    C = sum(chs)
    conv = (arr(cout, C, 3, 3, scale=0.1), arr(cout), arr(cout))
    if len(parts) == 1:
        rc, got, var = CK._run(lib, None, parts[0], *conv, relu)
        ref = CK.conv3x3_bn_relu_reference(parts[0], *conv, relu)
    else:
        gate = (parts, torch.sigmoid(arr(B, C)), arr(C, scale=0.3), arr(1)[0])
        rc, got, var = SK._run(lib, None, *gate, *conv, relu, True)
        ref = SK.scse_conv3x3_bn_relu_reference(*gate, *conv, relu, True)
    assert rc == 0 and var == "sm90"
    assert got.dtype == ref.dtype and got.shape == ref.shape
    _close(got, ref, TOL["bfloat16"][0])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("up0", [False, True], ids=["full", "up_part0"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", list(SHAPES) + list(PAIR_SHAPES))
def test_emulated_decode_pair_matches_plain(lib, shape, gated, up0, dtype):
    gate, conv1, conv2 = _inputs(shape, getattr(torch, dtype), up0, seed=3)
    args = (*gate, *conv1, *conv2, True, gated, up0)
    rc, y2, csum, var = PK._run(lib, None, *args)
    assert rc == 0 and var == _variant(gate[0])
    assert (var == "sm90") == (shape in PAIR_SHAPES and dtype == "bfloat16")
    r2, rsum = PK.scse_conv3x3_pair_reference(*args)
    assert y2.dtype == r2.dtype and y2.shape == r2.shape
    _close(y2, r2, TOL[dtype][0])
    _close(csum, rsum, TOL[dtype][1])
