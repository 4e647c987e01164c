"""Per-phase times of the sm90 conv body (``csrc/conv_sm90.cuh``,
``conv3x3_sm90_kernel``) on the GPU: K4, K3 and K2 on the bf16 path.

Builds copies of the body with compile-time switches applied, each with the
three libraries that include it (``conv3x3.cu``, ``scse_conv.cu``,
``decode_pair.cu``), all side by side (one nvcc each), and times each copy
with CUDA events, bf16, 24 views:

- K4 alone (the kernel, without the wrapper's weight arrangement) at
  chip_smoke's two K4 shapes, 448 → 64 and 64 → 64 at 512²;
- K3 (gate map + gated conv), K2 ``pair`` (gate map + gated conv + conv with
  channel sums + their reduction) and K2 ``pair_up`` (the same with part 0's
  blend) at x_1_3, 256 + 64 + 64 + 64 → 64 at 512², through the ops'
  marshalling (``_run``).

The copies:

- ``full``: the body as committed (also checked against the plain versions);
- ``fill_only``: no wgmma (copies, shifts, gating, blend and epilogue);
- ``mma_only``: no copies and no box building (the producers only arrive);
- ``no_build``: the copies but not the producers' work on the landed lines
  (shifts, gating, blend);
- ``no_gate``: the gated producers without the gate's arithmetic;
- ``no_blend``: part 0's rows copied instead of blended (``pair_up``);
- ``no_csum``: K2's second stage without the channel sums;
- ``no_store``: no output stores;
- ``pw2``: 2 producer warps instead of 4.

A switched-off copy computes wrong values; only its time is read. Each copy
runs in its own process. Prints the card's name and power limit. Needs a
CUDA device; imports no JAX::

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

BODY = "conv_sm90.cuh"
LIBS = ("conv3x3", "scse_conv", "decode_pair")
MMA = "sm90::wgmma_m64n64k16_bf16<1, 1>(acc[r], da, db, kc > 0 || tap > 0);"
PROD_A = ("      if (lane == 0) {\n"
          "        const Sm90Maps& m = p.maps[part];")
PROD_B = "      if (lane % 32 == 0) sm90::mbar_arrive(&full[s]);"
BUILD_A = "      if (half)\n        build_boxes<GATE, UP0>"
BUILD_B = "build_boxes<GATE, false>(st, hs, gs, gc, cvalid, y0, p.H, lane);\n"
GATE = "    if constexpr (GATE) {\n      const float g ="
BLEND = ("  return pack2(blend_f(r, lo_f(a), lo_f(c)), "
         "blend_f(r, hi_f(a), hi_f(c)));")
CSUM = "if constexpr (CSUM)"
STORE = "if (y < p.H && x < p.W && n0 + n < p.cout) {"
PW = "constexpr int kPW = 4; "
BUILD = REPO / "build" / "sm90_phases"
X_1_3 = ([256, 64, 64, 64], 64, 512)


def variants():
    src = (_build.CSRC / BODY).read_text()
    for text in (MMA, PROD_A, PROD_B, BUILD_A, BUILD_B, GATE, BLEND, CSUM,
                 STORE, PW):
        assert text in src, f"the source no longer has: {text}"
    i0, i1 = src.index(PROD_A), src.index(PROD_B) + len(PROD_B)
    # mma_only: full[s] still gets its 1 + kPW arrivals, with no copies
    arrive_only = ("      if (lane % 32 == 0) sm90::mbar_arrive(&full[s]);\n"
                   "      if (lane == 0) sm90::mbar_arrive(&full[s]);")
    b0 = src.index(BUILD_A)
    b1 = src.index(BUILD_B, b0) + len(BUILD_B)      # both calls
    return {
        "full": src,
        "fill_only": src.replace(MMA, "(void)da; (void)db;"),
        "mma_only": src[:i0] + arrive_only + src[i1:],
        "no_build": src[:b0] + src[b1:],
        "no_gate": src.replace(GATE, GATE.replace("(GATE)", "(false)")),
        "no_blend": src.replace(BLEND, "  return a;"),
        "no_csum": src.replace(CSUM, "if constexpr (false)"),
        "no_store": src.replace(STORE, "if (y < 0) {"),
        "pw2": src.replace(PW, "constexpr int kPW = 2; "),
    }


def build(name, lib):
    d = BUILD / name
    cu = _build._KERNELS[lib][0]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
                           str(d / f"lib{lib}.so"), str(d / cu)],
                          capture_output=True, text=True)
    return name, lib, proc.returncode, proc.stdout + proc.stderr


def load(name, lib):
    cdll = ctypes.CDLL(str(BUILD / name / f"lib{lib}.so"))
    for fn, argtypes in _build._KERNELS[lib][1].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def run_one(name):
    """Times one built copy; checks the committed one against plain."""
    import torch

    import chip_smoke as cs
    from eyediseasesegmentation_tpu_torch.ops import conv as CK
    from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
    from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

    libs = {lib: load(name, lib) for lib in LIBS}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    failed = False

    def report(what, ms, got=None, ref=None):
        nonlocal failed
        line = f"{name} {what}: {ms:.4f} ms"
        if name == "full":
            for g, r in zip(got, ref):
                err, top = cs.rel_err(g, r)
                bound = cs.CONV_TOL["bfloat16"] * top
                failed |= not err <= bound
                line += f" (max_abs_err {err:.4g}, bound {bound:.4g})"
        print(line, flush=True)

    for shape, (cin, cout, res) in cs.K4_SHAPES.items():
        a = cs.conv_inputs([cin], cout, res, cs.VIEWS, torch.bfloat16, dev,
                           gen)
        x, k, sc, bi = a["parts"][0], a["k1"], a["s1"], a["b1"]
        wt = SK.sm90_weight_operand(k).to(dev)
        sc, bi = sc.float().contiguous(), bi.float().contiguous()
        out = torch.empty(cs.VIEWS, cout, res, res, dtype=torch.bfloat16,
                          device=dev)

        def kernel():
            rc = libs["conv3x3"].conv3x3_fwd(
                1, CK.VARIANTS["sm90"], x.data_ptr(), wt.data_ptr(),
                sc.data_ptr(), bi.data_ptr(), out.data_ptr(), cs.VIEWS, res,
                res, cin, cout, int(wt.shape[0]) * 64, 1,
                ctypes.c_void_p(stream))
            assert rc == 0, f"CUDA error {rc}"

        ms = cs.time_ms(kernel, 10, warm=2)
        ref = ([CK.conv3x3_bn_relu_reference(x, k, sc, bi, True)]
               if name == "full" else None)
        report(f"K4 {shape} {cin}->{cout}@{res}", ms, [out], ref)
        del a, x, out, ref
        torch.cuda.empty_cache()

    chs, cout, res = X_1_3
    a = cs.conv_inputs(chs, cout, res, cs.VIEWS, torch.bfloat16, dev, gen)
    half = [a["parts"][0][:, :, ::2].contiguous()] + a["parts"][1:]
    g = (a["gate_c"], a["sse_k"], a["sse_b"])
    c1 = (a["k1"], a["s1"], a["b1"])
    c2 = (a["k2"], a["s2"], a["b2"])
    calls = {
        "K3": (lambda: SK._run(libs["scse_conv"], stream, a["parts"], *g, *c1,
                               True, True),
               lambda: SK.scse_conv3x3_bn_relu_reference(a["parts"], *g,
                                                         *c1)),
        "K2 pair": (lambda: PK._run(libs["decode_pair"], stream, a["parts"],
                                    *g, *c1, *c2, True, True, False),
                    lambda: PK.scse_conv3x3_pair_reference(a["parts"], *g,
                                                           *c1, *c2)),
        "K2 pair_up": (lambda: PK._run(libs["decode_pair"], stream, half, *g,
                                       *c1, *c2, True, True, True),
                       lambda: PK.scse_conv3x3_pair_reference(
                           half, *g, *c1, *c2, up_part0=True)),
    }
    for what, (kern, plain) in calls.items():
        res_ = kern()
        assert res_[0] == 0 and res_[-1] == "sm90", res_[0]
        torch.cuda.synchronize()
        ms = cs.time_ms(kern, 10, warm=2)
        got, ref = res_[1:-1], None
        if name == "full":
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
        report(f"{what} x_1_3 {sum(chs)}->{cout}@{res}", ms, got, ref)
        del res_, got, ref
        torch.cuda.empty_cache()
    return 1 if failed else 0


def main():
    srcs = variants()
    for name, source in srcs.items():
        d = BUILD / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / BODY).write_text(source)
    jobs = [(name, lib) for name in srcs for lib in LIBS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    for name, lib, rc, log in built:
        if rc:
            print(f"{name} {lib}: nvcc failed\n{log[-3000:]}", flush=True)
            return 1
        if name == "full" and lib == "decode_pair":
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
