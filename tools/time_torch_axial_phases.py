"""Per-phase times of K1 (fused axial attention) on the GPU, bf16, at the
five main-path shapes (``chip_smoke.K1_SHAPES``, 24 views of 1024²) and the
five vessel-path shapes (``chip_smoke.VESSEL_K1_SHAPES``, 16 views of 608²:
L 38 and 19, which the sm90 kernel pads to 64 and 32).

Builds copies of ``csrc/axial_attention.cu`` with compile-time switches
applied, one nvcc each, side by side, and times each copy with CUDA events
through the op's own marshalling (``ops/axial_attention.py`` ``_run``,
wrapper included), once per variant that it switches:

- ``full``: the kernel as committed (also checked against the plain
  version, 3e-2 of max|ref|);
- ``no_proj``: no projection (the projected tiles are left as they are;
  sm90: no copies and no wgmma);
- ``no_logits``: no logits (qr, kr, dots and their affine);
- ``no_softmax``: no softmax (sm90: no exponentials);
- ``no_out_kv``: no ``out = attn·v`` and no ``kv = attn·r_v``;
- ``no_store``: no output stores;
- ``one_block`` (sm90): one block per SM at every shape.

A switched-off copy computes wrong values; only its time is read. Each copy
runs in its own process. Prints the card's name and power limit. Needs a
CUDA device; imports no JAX::

    python3 tools/time_torch_axial_phases.py            # every variant
    python3 tools/time_torch_axial_phases.py wmma       # one variant
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

LIB = "axial_attention"
BUILD = REPO / "build" / "axial_phases"

# variant -> (source file, {phase: [(text, replacement), ...]})
SWITCHES = {
    "wmma": ("axial_attention.cu", {
        "no_proj": [("  project(static_cast<const T*>(p.xq)",
                     "  if (L < 0) project(static_cast<const T*>(p.xq)"),
                    ("  project(static_cast<const T*>(p.xv)",
                     "  if (L < 0) project(static_cast<const T*>(p.xv)")],
        "no_logits": [("for (int e = threadIdx.x; e < L * L; e += kThreads)",
                       "for (int e = threadIdx.x; e < 0; e += kThreads)")],
        "no_softmax": [("for (int row = warp; row < G * L; row += kWarps)",
                        "for (int row = warp; row < 0; row += kWarps)")],
        "no_out_kv": [("for (int j0 = 0; j0 < L; j0 += 8) {",
                       "for (int j0 = 0; j0 < 0; j0 += 8) {"),
                      ("for (int j = 0; j < L; ++j) {\n        const float r",
                       "for (int j = 0; j < 0; ++j) {\n        const float r")],
        "no_store": [("              out[static_cast<size_t>(d) * nv + c] = "
                      "from_f<T>(\n",
                      "              if (L < 0) out[static_cast<size_t>(d) * "
                      "nv + c] = from_f<T>(\n"),
                     ("          out[static_cast<size_t>(d) * nv + c] =\n",
                      "          if (L < 0) out[static_cast<size_t>(d) * nv + "
                      "c] =\n")],
    }),
    "sm90": ("axial_sm90.cuh", {
        "no_proj": [("    if (threadIdx.x == kConsumers) produce(",
                     "    if (LP < 0) produce("),
                    ("  project(p, base, full, empty, KQ, V);",
                     "  if (LP < 0) project(p, base, full, empty, KQ, V);")],
        "no_logits": [("for (int e0 = tid; e0 < q.rg * LP;",
                       "for (int e0 = tid; e0 < 0;"),
                      ("      sm90::mma_m16n8k8_bf16(sc[nt], qa0, qa1, kb0);",
                       "      (void)kb0;")],
        "no_softmax": [("expf(", "(")],
        "no_out_kv": [("for (int it0 = warp; it0 < items;",
                       "for (int it0 = warp; it0 < 0;"),
                      ("        sm90::ldmatrix_x2_trans(b, vrow + 16 * kt * "
                       "q.ldv + 8 * dt);\n        sm90::mma_m16n8k16_bf16(o[dt], "
                       "pa[kt], b[0], b[1]);", "        (void)b;")],
        "no_store": [("        if (d < L)   // the pass's sequence is below b\n",
                      "        if (d < 0)\n")],
        "one_block": [("constexpr int kBlocksPerSM = DV <= 16 ? 2 : 1;",
                       "constexpr int kBlocksPerSM = 1;")],
    }),
}


def sources(var):
    """{copy name: (file name, text)} of one variant's copies."""
    fname, phases = SWITCHES[var]
    src = (_build.CSRC / fname).read_text()
    out = {f"{var}_full": (fname, src)}
    for phase, edits in phases.items():
        text = src
        for old, new in edits:
            assert old in text, f"{fname} no longer has: {old!r}"
            text = text.replace(old, new)
        out[f"{var}_{phase}"] = (fname, text)
    return out


def build(name):
    d = BUILD / name
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
                           str(d / f"lib{LIB}.so"),
                           str(d / _build._KERNELS[LIB][0])],
                          capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def run_one(name):
    """Times one built copy; checks the committed one against plain."""
    import torch

    import chip_smoke as cs
    from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK

    var = name.split("_")[0]
    lib = ctypes.CDLL(str(BUILD / name / f"lib{LIB}.so"))
    for fn, argtypes in _build._KERNELS[LIB][1].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    failed, per_forward = False, {"main": 0.0, "vessel": 0.0}
    shapes = [("main", item) for item in cs.K1_SHAPES.items()]
    shapes += [("vessel", item) for item in cs.VESSEL_K1_SHAPES.items()]
    for path, (shape, (L, _, _, _, _, b, calls)) in shapes:
        args, kw = cs.k1_inputs(shape, torch.bfloat16, dev, gen)

        def kernel():
            rc, out, v = AK._run(lib, stream, *args, kw["heads"], kw["dkq"],
                                 kw["dv"], torch.bfloat16, force=var)
            assert rc == 0 and v == var, f"CUDA error {rc}"
            return out

        got = kernel()
        torch.cuda.synchronize()
        ms = cs.time_ms(kernel, 10, warm=2)
        per_forward[path] += calls * ms
        line = f"{name} {shape} L={L} b={b}: {ms:.4f} ms"
        if name.endswith("_full"):
            ref_args = list(args)
            ref_args[0], ref_args[1] = args[0].float(), args[1].float()
            ref = AK.axial_attention_reference(*ref_args, dtype=torch.float32,
                                               **kw)
            err, top = cs.rel_err(got, ref)
            bound = cs.K1_TOL["bfloat16"] * top
            failed |= not err <= bound
            line += f" (max_abs_err {err:.4g}, bound {bound:.4g})"
        print(line, flush=True)
        del args, got
        torch.cuda.empty_cache()
    for path, ms in per_forward.items():
        print(f"{name} per forward of the {path} path (12 calls): {ms:.4f} ms",
              flush=True)
    return 1 if failed else 0


def main(variants):
    srcs = {}
    for var in variants:
        srcs.update(sources(var))
    for name, (fname, text) in srcs.items():
        d = BUILD / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / fname).write_text(text)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(build, srcs))
    for name, rc, log in built:
        if rc:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            return 1
        if name.endswith("_full"):
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print(f"  ptxas: {ln.strip()}", flush=True)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    worst = 0
    for name in srcs:
        proc = subprocess.run([sys.executable, __file__, "--one", name],
                              text=True, capture_output=True, timeout=300)
        print(proc.stdout.rstrip(), flush=True)
        if proc.returncode:
            print(f"{name}: exit {proc.returncode}\n{proc.stderr[-1500:]}",
                  flush=True)
            worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    sys.exit(main(sys.argv[1:] or list(SWITCHES)))
