"""Time the PyTorch port's decode-node CUDA kernels at two main-path nodes.

    python3 tools/time_torch_decode_kernels.py

Builds K3 (``scse_conv3x3_bn_relu``), K2 (``scse_conv3x3_pair``, ``up_part0``
off and on) and K4 (``conv3x3_bn_relu``) with nvcc, prints each kernel's
registers and spills as ptxas reports them, and times the wrappers with CUDA
events at x_1_3 (448 → 64 at 512²) and x_0_2 (896 → 64 at 256²), bf16, 24
views, with one error check per node against the plain versions; then K4
alone at chip_smoke's two K4 shapes (448 → 64 and 64 → 64 at 512², bf16, 24
views), with the variant that ran, its error, and the library call (cuDNN
conv + BN + ReLU) and bound beside it. A quick loop for kernel work;
``chip_smoke.py`` is the full check. Needs a CUDA device; imports no JAX.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from eyediseasesegmentation_tpu_torch.ops import (_build, conv as CK,  # noqa: E402
                                                  decode_pair as PK,
                                                  scse_conv as SK)


def main():
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    names = ["conv3x3", "scse_conv", "decode_pair"]
    _build.load_all(names)
    for name in names:
        for ln in _build.build_info[name]["log"].splitlines():
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
                print("  ", ln.strip()[:150])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for node in ("x_1_3", "x_0_2"):
        chs, cout, res = cs.NODE_SHAPES[node]
        a = cs.conv_inputs(chs, cout, res, cs.VIEWS, torch.bfloat16, dev, gen)
        g = (a["parts"], a["gate_c"], a["sse_k"], a["sse_b"])
        c1, c2 = (a["k1"], a["s1"], a["b1"]), (a["k2"], a["s2"], a["b2"])
        half = [a["parts"][0][:, :, ::2].contiguous()] + a["parts"][1:]
        x = torch.cat(a["parts"], 1)
        calls = {
            "K3": lambda: SK.scse_conv3x3_bn_relu(*g, *c1),
            "K3 ungated": lambda: SK.scse_conv3x3_bn_relu(*g, *c1,
                                                          gated=False),
            "K2": lambda: PK.scse_conv3x3_pair(*g, *c1, *c2),
            "K2 up_part0": lambda: PK.scse_conv3x3_pair(
                half, *g[1:], *c1, *c2, up_part0=True),
            "K4": lambda: CK.conv3x3_bn_relu(x, *c1),
        }
        print(node, ", ".join(f"{k} {cs.time_ms(fn, 5, warm=1):.3f} ms"
                              for k, fn in calls.items()), flush=True)
        err = cs.rel_err(calls["K3"](),
                         SK.scse_conv3x3_bn_relu_reference(*g, *c1))
        y2, csum = calls["K2 up_part0"]()
        r2, rsum = PK.scse_conv3x3_pair_reference(half, *g[1:], *c1, *c2,
                                                  up_part0=True)
        print(f"  (max_abs_err, max|ref|): K3 {err}, K2 up_part0 y2 "
              f"{cs.rel_err(y2, r2)} csum {cs.rel_err(csum, rsum)}")
        del a, g, half, x, y2, csum, r2, rsum
        torch.cuda.empty_cache()
    time_k4(dev, gen)


def time_k4(dev, gen):
    """K4 at chip_smoke's K4 shapes: kernel, library and bound ms."""
    import torch.nn.functional as F
    for shape, (cin, cout, res) in cs.K4_SHAPES.items():
        a = cs.conv_inputs([cin], cout, res, cs.VIEWS, torch.bfloat16, dev, gen)
        x, (k, sc, bi) = a["parts"][0], (a["k1"], a["s1"], a["b1"])

        def lib():
            y = F.conv2d(x, k.bfloat16(), padding=1)
            return torch.relu(y * sc.bfloat16().view(1, -1, 1, 1)
                              + bi.bfloat16().view(1, -1, 1, 1))

        var = CK.variant(x.dtype, res, x.data_ptr())
        t_k = cs.time_ms(lambda: CK.conv3x3_bn_relu(x, k, sc, bi), 10, warm=2)
        t_l = cs.time_ms(lib, 10, warm=2)
        f = 2 * 9 * cin * cout * cs.VIEWS * res * res
        nb = 2 * (cs.VIEWS * res * res * (cin + cout) + 9 * cin * cout)
        b_ms, b_by = cs.bound_ms(f, nb)
        err = cs.rel_err(CK.conv3x3_bn_relu(x, k, sc, bi),
                         CK.conv3x3_bn_relu_reference(x, k, sc, bi))
        print(f"K4 {shape} {cin}->{cout}@{res} b={cs.VIEWS} {var}: kernel "
              f"{t_k:.3f} ms, library {t_l:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}); (max_abs_err, max|ref|) {err}", flush=True)
        del a, x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
