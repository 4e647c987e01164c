"""Per-phase times of K4's sm90 kernel (``csrc/conv3x3.cu``,
``conv3x3_sm90_kernel``) on the GPU.

Builds copies of the source with compile-time switches applied, side by side
(one nvcc each), and times each copy's kernel alone with CUDA events at
chip_smoke's two K4 shapes (448 → 64 and 64 → 64 at 512², bf16, 24 views):

- ``full``: the kernel as committed (also checked against the plain version);
- ``fill_only``: no wgmma (copies, shifts and epilogue);
- ``mma_only``: no copies and no shifts (the producers only arrive);
- ``no_shift``: the copies but not the shifts that build the dx = 0 / 2 boxes;
- ``no_store``: no output stores;
- ``one_producer_warp``: the shifts by one producer warp instead of two.

Each copy runs in its own process. Prints the card's name and power limit.
Needs a CUDA device; imports no JAX::

    python3 tools/time_torch_conv_sm90_phases.py
"""

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from eyediseasesegmentation_tpu_torch.ops import _build  # noqa: E402

MMA = "sm90::wgmma_m64n64k16_bf16<1, 1>(acc[r], da, db, kc > 0 || tap > 0);"
PROD_A = "      if (lane == 0) {\n        sm90::mbar_arrive_expect_tx(&landed[s]"
PROD_B = "      if (lane % 32 == 0) sm90::mbar_arrive(&full[s]);"
SHIFT = ("      shift_boxes(st + kBox, st + 3 * kBox, st + 3 * kBox + kEdge, st,\n"
         "                  st + 2 * kBox, lane);")
STORE = "if (y < p.H && x < p.W && n0 + n < p.cout) {"
PW = "constexpr int kPW = 2; "
BUILD = REPO / "build" / "k4_phases"


def variants():
    src = (_build.CSRC / "conv3x3.cu").read_text()
    for text in (MMA, PROD_A, PROD_B, SHIFT, STORE, PW):
        assert text in src, f"the source no longer has: {text}"
    i0, i1 = src.index(PROD_A), src.index(PROD_B) + len(PROD_B)
    # mma_only: full[s] still gets its 1 + kPW arrivals, with no copies
    arrive_only = ("      if (lane % 32 == 0) sm90::mbar_arrive(&full[s]);\n"
                   "      if (lane == 0) sm90::mbar_arrive(&full[s]);")
    return {
        "full": src,
        "fill_only": src.replace(MMA, "(void)da; (void)db;"),
        "mma_only": src[:i0] + arrive_only + src[i1:],
        "no_shift": src.replace(SHIFT, ""),
        "no_store": src.replace(STORE, "if (y < 0) {"),
        "one_producer_warp": src.replace(PW, "constexpr int kPW = 1; "),
    }


def build(name, source):
    d = BUILD / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    (d / "conv3x3.cu").write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
                           str(d / "lib.so"), str(d / "conv3x3.cu")],
                          capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def run_one(name):
    """Times one built copy; checks the committed one against plain."""
    import torch

    import chip_smoke as cs
    from eyediseasesegmentation_tpu_torch.ops import conv as CK

    lib = ctypes.CDLL(str(BUILD / name / "lib.so"))
    lib.conv3x3_fwd.argtypes = _build._KERNELS["conv3x3"][1]["conv3x3_fwd"]
    lib.conv3x3_fwd.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    failed = False
    for shape, (cin, cout, res) in cs.K4_SHAPES.items():
        a = cs.conv_inputs([cin], cout, res, cs.VIEWS, torch.bfloat16, dev, gen)
        x, k, sc, bi = a["parts"][0], a["k1"], a["s1"], a["b1"]
        wt = CK.sm90_weight_operand(k).to(dev)
        sc, bi = sc.float().contiguous(), bi.float().contiguous()
        out = torch.empty(cs.VIEWS, cout, res, res, dtype=torch.bfloat16,
                          device=dev)

        def kernel():
            rc = lib.conv3x3_fwd(1, CK.VARIANTS["sm90"], x.data_ptr(),
                                 wt.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                 out.data_ptr(), cs.VIEWS, res, res, cin, cout,
                                 int(wt.shape[0]) * 64, 1,
                                 ctypes.c_void_p(stream))
            assert rc == 0, f"CUDA error {rc}"

        ms = cs.time_ms(kernel, 10, warm=2)
        line = f"{name} {shape} {cin}->{cout}@{res}: {ms:.4f} ms"
        if name == "full":
            ref = CK.conv3x3_bn_relu_reference(x, k, sc, bi, True)
            err = (out.float() - ref.float()).abs().max().item()
            bound = cs.CONV_TOL["bfloat16"] * ref.abs().max().item()
            failed |= not err <= bound
            line += f" (max_abs_err {err:.4g}, bound {bound:.4g})"
        print(line, flush=True)
        del a, x, out
        torch.cuda.empty_cache()
    return 1 if failed else 0


def main():
    srcs = variants()
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), srcs.items()))
    for name, rc, log in built:
        if rc:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            return 1
        if name == "full":
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln or "conv3x3_sm90" in ln:
                    print(f"  ptxas: {ln.strip()}", flush=True)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    worst = 0
    for name in srcs:
        proc = subprocess.run([sys.executable, __file__, name], text=True,
                              capture_output=True, timeout=300)
        print(proc.stdout.rstrip(), flush=True)
        if proc.returncode:
            print(f"{name}: exit {proc.returncode}\n{proc.stderr[-1500:]}",
                  flush=True)
            worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(run_one(sys.argv[1]) if len(sys.argv) > 1 else main())
