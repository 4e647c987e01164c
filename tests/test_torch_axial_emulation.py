"""K1's sm90 kernel (``csrc/axial_sm90.cuh``), rehearsed on the CPU.

A CUDA kernel has no interpret mode, so ``tests/test_torch_kernels.py`` needs
a GPU. This file compiles the sm90 kernel with g++ against the stand-in
headers of ``tests/torch_cuda_emulation/`` (a std::thread per CUDA thread;
mbarriers under a lock; a TMA that copies and swizzles the box; wgmma that
reads its K-major operands back through their descriptors; mma.sync and
ldmatrix at the positions of the PTX fragment layouts) and drives it through
the op's own marshalling (``_run``) on CPU tensors, against the plain
version. It checks index arithmetic, masking, staging and the rounding points
at small shapes: L = 32 (two sequences a block, an odd count of them) and
64, and lengths the kernel pads (38 and 50 to 64; 19 and 7 to 32, two
sequences a block, an odd count of them: the padded rows are the TMA's zero
fill, the padded keys masked), self- and cross-attention, 4 and 8 heads, dv
8, 16, 32 and 64, products of one and of several column passes (the
resident x), K not a multiple of 64 (the TMA's zero fill), and that the
wrapper's shared-memory plan is the kernel's; it says nothing of what nvcc
accepts, of speed, or of the memory model. Tolerance: 3e-2 of max|ref|,
against the plain version in fp32 on the same bf16 inputs, as on the GPU.
Skips without g++ (C++20).
Imports no JAX.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch.ops import _build
from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK

EMU = Path(__file__).resolve().parent / "torch_cuda_emulation"
TOL = 3e-2
# (b, L, Cq, Cv or None for self-attention, heads, dv)
SHAPES = {
    "self_l64_h8_dv16": (1, 64, 96, None, 8, 16),     # 2 passes, resident x
    "self_l32_h8_dv64": (3, 32, 64, None, 8, 64),     # 5 passes, odd b
    "cross_l32_h4_dv16": (3, 32, 80, 24, 4, 16),
    "cross_l64_h4_dv8": (1, 64, 136, 32, 4, 8),       # 3 chunks of x_q
    # padded lengths
    "self_l38_h8_dv16": (2, 38, 96, None, 8, 16),     # to 64, 2 passes
    "cross_l19_h4_dv16": (3, 19, 80, 24, 4, 16),      # to 32, odd b
    "cross_l50_h8_dv8": (1, 50, 72, 40, 8, 8),        # to 64
    "self_l7_h4_dv32": (3, 7, 64, None, 4, 32),       # to 32, 2 passes
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("emu") / "libaxial_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", f"-I{EMU}", f"-I{_build.CSRC}", "-o",
         str(out), str(EMU / "axial_kernels.cpp")],
        capture_output=True, text=True)
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("g++ does not know -std=c++20")
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for name in ("axial_attention_sm90_scratch", "axial_attention_sm90_fwd"):
        fn = getattr(lib, name)
        fn.argtypes = _build._KERNELS["axial_attention"][1][name]
        fn.restype = ctypes.c_int
    lib.emu_last_smem.restype = ctypes.c_longlong
    return lib


def _inputs(shape, dkq=8, seed=0):
    b, L, cq, cv, H, dv = SHAPES.get(shape, shape)
    cross = cv is not None
    nkq = H * (2 * dkq + (0 if cross else dv))
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0, positive=False):
        a = rng.randn(*s) * scale
        return torch.from_numpy((np.abs(a) if positive else a)
                                .astype(np.float32))

    x_q = arr(b, L, cq).to(torch.bfloat16)
    x_v = arr(b, L, cv).to(torch.bfloat16) if cross else x_q
    w_kq = arr(cq, nkq, scale=cq ** -0.5)
    w_v = arr(cv, H * dv, scale=cv ** -0.5) if cross else None
    kq_aff = (arr(nkq, positive=True), arr(nkq, scale=0.1))
    v_aff = ((arr(H * dv, positive=True), arr(H * dv, scale=0.1)) if cross
             else None)
    r = [arr(n, L, L) for n in (dkq, dkq, dv)]
    logit_aff = (arr(H * 3, scale=dkq ** -0.5, positive=True),
                 arr(H * 3, scale=0.1))
    out_aff = (arr(2 * H * dv, positive=True), arr(2 * H * dv, scale=0.1))
    return ([x_q, x_v, w_kq, w_v, kq_aff, v_aff, *r, logit_aff, out_aff],
            dict(heads=H, dkq=dkq, dv=dv))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_axial_sm90_matches_plain(lib, shape):
    args, kw = _inputs(shape)
    rc, got, var = AK._run(lib, None, *args, kw["heads"], kw["dkq"], kw["dv"],
                           torch.bfloat16)
    assert rc == 0 and var == "sm90"
    # the wrapper's shared-memory plan is the kernel's, byte for byte
    _, L, cq, cv, H, dv = SHAPES[shape]
    assert lib.emu_last_smem() == AK.sm90_smem(L, H, dv, cq, cv or cq,
                                               cv is None)
    ref_args = list(args)
    ref_args[0], ref_args[1] = args[0].float(), args[1].float()
    ref = AK.axial_attention_reference(*ref_args, dtype=torch.float32, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL * ref.abs().max().item(), (err, ref.abs().max().item())


def test_emulated_axial_sm90_refuses_what_it_cannot_take(lib):
    args, kw = _inputs((2, 80, 64, 32, 4, 16))     # L = 80: 64 at most
    assert AK.variant(torch.bfloat16, 80, 4, 8, 16, 64, 32, [0, 0],
                      False) == "wmma"
    with pytest.raises(ValueError, match="L <= 64"):
        AK._run(lib, None, *args, kw["heads"], kw["dkq"], kw["dv"],
                torch.bfloat16, force="sm90")
    # the library refuses it too, past the wrapper's check
    x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k, r_v, l_aff, o_aff = args
    out = torch.empty(2, 80, 4 * 16, dtype=torch.bfloat16)
    scratch = torch.empty(1 << 16, dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in (x_q, w_kq, *kq_aff, x_v, w_v, *v_aff, r_q,
                                   r_k, r_v, scratch, *l_aff, *o_aff, out)]
    assert lib.axial_attention_sm90_fwd(*ptrs, 2, 80, 64, 32, 4, 16, 0,
                                        None) != 0


# (L, Cq, Cv or None for self-attention, heads, dv) of K1's five main-path
# callers (chip_smoke.py K1_SHAPES), and the same callers on the vessel path
# (the flagship at 608²: L 38 and 19; chip_smoke.py VESSEL_K1_SHAPES)
MAIN_SHAPES = {
    "layer4_first": (64, 512, None, 8, 64),
    "layer4_shared": (32, 512, None, 8, 64),
    "x_0_0": (32, 2048, 64, 4, 16),
    "x_1_1": (64, 1024, 32, 4, 8),
    "x_0_1": (64, 256, 64, 4, 16),
}
VESSEL_SHAPES = {
    "vessel_layer4_first": (38, 512, None, 8, 64),
    "vessel_layer4_shared": (19, 512, None, 8, 64),
    "vessel_x_0_0": (19, 2048, 64, 4, 16),
    "vessel_x_1_1": (38, 1024, 32, 4, 8),
    "vessel_x_0_1": (38, 256, 64, 4, 16),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [*MAIN_SHAPES, *VESSEL_SHAPES])
def test_axial_variant_of_main_path_shapes(shape, dtype):
    L, cq, cv, H, dv = {**MAIN_SHAPES, **VESSEL_SHAPES}[shape]
    dt = getattr(torch, dtype)
    want = "sm90" if dt == torch.bfloat16 else "wmma"
    assert AK.variant(dt, L, H, 8, dv, cq, cv or cq, [0, 64],
                      cv is None) == want
    # a misaligned input, or a shared-memory plan over the limit, takes wmma
    assert AK.variant(dt, L, H, 8, dv, cq, cv or cq, [8, 64],
                      cv is None) == "wmma"
    assert AK.sm90_smem(L, H, dv, cq, cv or cq, cv is None) <= 232448
