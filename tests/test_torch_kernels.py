"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one. The file imports neither JAX nor the JAX package, so it also
runs where only torch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances, as fractions of max|reference|: 1e-4 in fp32 (TF32 off; the
kernel sums in another order), 3e-2 for bf16 inputs against the plain version
computed in fp32 on the same bf16 values (the kernel rounds the projected q,
k, v and the attention weights to bf16, as the Pallas kernel does). The
decode-node conv kernels round where their plain versions do, so in bf16 they
differ from them by single roundings that fall the other way after another
order of summation; the same bounds hold, and 1e-4 for the channel sums of
the pair kernel in fp32.
"""

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK
from eyediseasesegmentation_tpu_torch.ops import conv as CK
from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

# (b, L, Cq, Cv or None for self-attention, heads, dv): the five main-path
# callers of K1 with fewer sequences, and the same five on the vessel path
# (L 38 and 19, which the sm90 variant pads to 64 and 32); three shapes of
# the sm90 variant's edges (an odd count of L = 32 or L = 19 sequences, so
# the last block holds one; a K that is not a multiple of 64, which the TMA
# fills with zeros); and two ragged shapes that exercise the wmma kernel's
# row, depth and column masking (dv of 6 and 5 keep them on it in bf16); the
# second has channel counts that are not multiples of 8 (no 16-byte staging)
# and dv not a multiple of 4 (the one-channel-per-thread attention stage)
SHAPES = {
    "layer4_first": (48, 64, 512, None, 8, 64),
    "layer4_shared": (48, 32, 512, None, 8, 64),
    "x_0_0": (48, 32, 2048, 64, 4, 16),
    "x_1_1": (48, 64, 1024, 32, 4, 8),
    "x_0_1": (48, 64, 256, 64, 4, 16),
    "vessel_layer4_first": (24, 38, 512, None, 8, 64),
    "vessel_layer4_shared": (24, 19, 512, None, 8, 64),
    "vessel_x_0_0": (24, 19, 2048, 64, 4, 16),
    "vessel_x_1_1": (24, 38, 1024, 32, 4, 8),
    "vessel_x_0_1": (24, 38, 256, 64, 4, 16),
    "odd_l32": (5, 32, 512, None, 8, 64),
    "odd_l19": (5, 19, 80, 24, 4, 16),
    "k_tail": (6, 64, 136, 32, 4, 8),
    "ragged": (5, 20, 40, 24, 4, 6),
    "ragged_unaligned": (3, 24, 36, 20, 4, 5),
}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0, dkq=8):
    b, L, cq, cv, H, dv = SHAPES.get(shape, shape)
    cross = cv is not None
    nkq = H * (2 * dkq + (0 if cross else dv))
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0, positive=False):
        a = rng.randn(*s) * scale
        a = np.abs(a) if positive else a
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x_q = arr(b, L, cq).to(dtype)
    x_v = arr(b, L, cv).to(dtype) if cross else x_q
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_axial_attention_kernel_matches_plain(cuda_device, shape, dtype):
    dt = getattr(torch, dtype)
    args, kw = _inputs(shape, dt, cuda_device)
    before = AK.launches
    got = AK.axial_attention(*args, dtype=dt, **kw)
    torch.cuda.synchronize()
    assert AK.launches == before + 1
    ref_args = list(args)
    ref_args[0], ref_args[1] = args[0].float(), args[1].float()
    ref = AK.axial_attention_reference(*ref_args, dtype=torch.float32, **kw)
    assert got.dtype == dt and got.shape == ref.shape
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_axial_attention_kernel_variant(cuda_device, shape, dtype):
    # the main-path and vessel shapes and the sm90 edge shapes take the sm90
    # kernel in bf16; fp32 and the ragged shapes the wmma kernel
    dt = getattr(torch, dtype)
    args, kw = _inputs(shape, dt, cuda_device)
    _, L, cq, cv, _, _ = SHAPES[shape]
    want = ("sm90" if dt == torch.bfloat16 and shape not in
            ("ragged", "ragged_unaligned") else "wmma")
    assert AK.variant(dt, L, kw["heads"], kw["dkq"], kw["dv"], cq, cv or cq,
                      [args[0].data_ptr(), args[1].data_ptr()],
                      cv is None) == want
    before = AK.launches_sm90, AK.launches_wmma
    AK.axial_attention(*args, dtype=dt, **kw)
    torch.cuda.synchronize()
    assert (AK.launches_sm90, AK.launches_wmma) == (
        before[0] + (want == "sm90"), before[1] + (want == "wmma"))


@pytest.mark.cuda
def test_axial_attention_kernel_refuses_what_it_cannot_take(cuda_device):
    args, kw = _inputs("ragged", torch.float16, cuda_device)
    with pytest.raises(TypeError):
        AK.axial_attention(*args, dtype=torch.float16, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
def test_axial_attention_kernel_refuses_shapes_neither_variant_takes(
        cuda_device, dtype):
    dt = getattr(torch, dtype)
    args, kw = _inputs((2, 80, 64, None, 4, 16), dt, cuda_device)  # L > 64
    before = AK.launches
    with pytest.raises(ValueError, match="L <= 64"):
        AK.axial_attention(*args, dtype=dt, **kw)
    assert AK.launches == before


# (part channels, cout, B, H, W) of the decode-node conv kernels: the four
# main-path nodes at a reduced batch (x_0_2 runs at 256², the others at
# 512²), and ragged shapes: odd W, ΣC and cout not multiples of 8, H smaller
# than a tile, B = 1, more than 64 output channels (two passes; the pair's
# wmma variant keeps y1 in device memory there)
CONV_SHAPES = {
    "x_3_3": ([256, 64], 64, 2, 512, 512),
    "x_2_3": ([256, 64, 64], 64, 1, 512, 512),
    "x_1_3": ([256, 64, 64, 64], 64, 1, 512, 512),
    "x_0_2": ([128, 256, 256, 256], 64, 2, 256, 256),
    "ragged": ([5, 6], 12, 1, 5, 35),
    "ragged_rows": ([24, 9], 20, 3, 23, 77),
    "wide": ([8, 8], 100, 1, 8, 33),
}


# (part channels, cout, B, H, W) of the sm90 variants of K3 and K2 (bf16,
# W % 8 == 0, every part a multiple of 16 channels): x_1_3 at batch 1, and
# two parts at W = 72 (a partial second tile) with odd H (even under
# up_part0) and cout 24 (a padded pass) or 100 (two passes of 64 output
# channels, the second padded, with their channel sums)
SM90_NODE_SHAPES = {
    "x_1_3": ([256, 64, 64, 64], 64, 1, 512, 512),
    "w72_odd": ([32, 16], 24, 2, 9, 72),
    "w72_wide": ([32, 16], 100, 2, 9, 72),
}


def _conv_inputs(shape, dtype, device, up0=False, seed=0):
    chs, cout, B, H, W = {**CONV_SHAPES, **SM90_NODE_SHAPES}[shape]
    W += W % 2 if up0 else 0
    H += H % 2 if up0 else 0
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*s) * scale).astype(np.float32)).to(device)

    parts = [arr(B, c, H, W).to(dtype) for c in chs]
    if up0:
        parts[0] = torch.nn.functional.interpolate(
            arr(B, chs[0], H // 2, W // 2), scale_factor=(1, 2),
            mode="bilinear", align_corners=False).to(dtype)
    C = sum(chs)
    return dict(
        parts=parts, gate_c=torch.sigmoid(arr(B, C)),
        sse_kernel=arr(C, scale=C ** -0.5), sse_bias=arr(1)[0],
        k1=arr(cout, C, 3, 3, scale=(9 * C) ** -0.5),
        s1=arr(cout).abs() + 0.5, b1=arr(cout, scale=0.1),
        k2=arr(cout, cout, 3, 3, scale=(9 * cout) ** -0.5),
        s2=arr(cout).abs() + 0.5, b2=arr(cout, scale=0.1))


def _close(got, ref, tol):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_scse_conv_kernel_matches_plain(cuda_device, shape, gated, dtype):
    dt = getattr(torch, dtype)
    a = _conv_inputs(shape, dt, cuda_device)
    args = (a["parts"], a["gate_c"], a["sse_kernel"], a["sse_bias"], a["k1"],
            a["s1"], a["b1"])
    before = SK.launches
    got = SK.scse_conv3x3_bn_relu(*args, relu=gated, gated=gated)
    torch.cuda.synchronize()
    assert SK.launches == before + 1
    ref = SK.scse_conv3x3_bn_relu_reference(*args, relu=gated, gated=gated)
    assert got.dtype == dt and got.shape == ref.shape
    _close(got, ref, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_conv3x3_kernel_matches_plain(cuda_device, shape, relu, dtype):
    dt = getattr(torch, dtype)
    a = _conv_inputs(shape, dt, cuda_device)
    x = torch.cat(a["parts"], 1)
    var = CK.variant(dt, x.shape[3], x.data_ptr())
    before = CK.launches, getattr(CK, f"launches_{var}")
    got = CK.conv3x3_bn_relu(x, a["k1"], a["s1"], a["b1"], relu=relu)
    torch.cuda.synchronize()
    assert (CK.launches, getattr(CK, f"launches_{var}")) == (before[0] + 1,
                                                             before[1] + 1)
    ref = CK.conv3x3_bn_relu_reference(x, a["k1"], a["s1"], a["b1"], relu)
    assert got.dtype == dt and got.shape == ref.shape
    _close(got, ref, TOL[dtype])


# (C, cout, B, H, W) of the sm90 kernel (bf16, W % 8 == 0): the two shapes
# chip_smoke times (448 -> 64 and 64 -> 64 at 512²) at batch 2; one and two
# tiles across, three chunks, two passes and a ragged bottom edge; a C that
# is not a multiple of 16 and cout below 16
SM90_SHAPES = {
    "conv1_x_1_3": (448, 64, 2, 512, 512),
    "conv2": (64, 64, 2, 512, 512),
    "w64": (96, 80, 1, 11, 64),
    "w72": (96, 80, 1, 11, 72),
    "c_tail": (20, 8, 2, 9, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape", list(SM90_SHAPES))
def test_conv3x3_sm90_kernel_matches_plain(cuda_device, shape, relu):
    C, cout, B, H, W = SM90_SHAPES[shape]
    rng = np.random.RandomState(5)

    def arr(*s, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*s) * scale).astype(np.float32)).to(cuda_device)

    x = arr(B, C, H, W).to(torch.bfloat16)
    conv = (arr(cout, C, 3, 3, scale=(9 * C) ** -0.5), arr(cout).abs() + 0.5,
            arr(cout, scale=0.1))
    assert CK.variant(x.dtype, W, x.data_ptr()) == "sm90"
    before = CK.launches_sm90
    got = CK.conv3x3_bn_relu(x, *conv, relu=relu)
    torch.cuda.synchronize()
    assert CK.launches_sm90 == before + 1
    ref = CK.conv3x3_bn_relu_reference(x, *conv, relu)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _close(got, ref, TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("up0", [False, True], ids=["full", "up_part0"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_decode_pair_kernel_matches_plain(cuda_device, shape, gated, up0,
                                          dtype):
    dt = getattr(torch, dtype)
    a = _conv_inputs(shape, dt, cuda_device, up0=up0)
    args = (a["parts"], a["gate_c"], a["sse_kernel"], a["sse_bias"], a["k1"],
            a["s1"], a["b1"], a["k2"], a["s2"], a["b2"])
    before = PK.launches
    y2, csum = PK.scse_conv3x3_pair(*args, gated=gated, up_part0=up0)
    again = PK.scse_conv3x3_pair(*args, gated=gated, up_part0=up0)[1]
    torch.cuda.synchronize()
    assert PK.launches == before + 2
    r2, rsum = PK.scse_conv3x3_pair_reference(*args, gated=gated,
                                              up_part0=up0)
    assert y2.dtype == dt and y2.shape == r2.shape
    assert csum.dtype == torch.float32 and csum.shape == rsum.shape
    _close(y2, r2, TOL[dtype])
    _close(csum, rsum, 1e-4 if dt == torch.float32 else TOL[dtype])
    assert torch.equal(csum, again)       # fixed summation order


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["scse_conv", "pair", "pair_up"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", list(SM90_NODE_SHAPES))
def test_decode_node_sm90_kernels_match_plain(cuda_device, shape, gated,
                                              kernel):
    up0 = kernel == "pair_up"
    a = _conv_inputs(shape, torch.bfloat16, cuda_device, up0=up0, seed=6)
    parts = a["parts"]
    assert SK.variant(torch.bfloat16, parts[0].shape[3],
                      [p.data_ptr() for p in parts],
                      [p.shape[1] for p in parts]) == "sm90"
    args = (parts, a["gate_c"], a["sse_kernel"], a["sse_bias"], a["k1"],
            a["s1"], a["b1"])
    if kernel == "scse_conv":
        before = SK.launches_sm90
        got = SK.scse_conv3x3_bn_relu(*args, relu=gated, gated=gated)
        torch.cuda.synchronize()
        assert SK.launches_sm90 == before + 1
        ref = SK.scse_conv3x3_bn_relu_reference(*args, relu=gated,
                                                gated=gated)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _close(got, ref, TOL["bfloat16"])
        return
    args += (a["k2"], a["s2"], a["b2"])
    before = PK.launches_sm90
    y2, csum = PK.scse_conv3x3_pair(*args, gated=gated, up_part0=up0)
    again = PK.scse_conv3x3_pair(*args, gated=gated, up_part0=up0)[1]
    torch.cuda.synchronize()
    assert PK.launches_sm90 == before + 2
    r2, rsum = PK.scse_conv3x3_pair_reference(*args, gated=gated,
                                              up_part0=up0)
    assert y2.dtype == torch.bfloat16 and y2.shape == r2.shape
    _close(y2, r2, TOL["bfloat16"])
    _close(csum, rsum, TOL["bfloat16"])
    assert torch.equal(csum, again)       # fixed summation order


@pytest.mark.cuda
def test_conv_kernels_refuse_what_they_cannot_take(cuda_device):
    a = _conv_inputs("wide", torch.float32, cuda_device)
    args = (a["parts"], a["gate_c"], a["sse_kernel"], a["sse_bias"], a["k1"],
            a["s1"], a["b1"], a["k2"], a["s2"], a["b2"])
    half = [p.half() for p in a["parts"]]
    with pytest.raises(TypeError):
        SK.scse_conv3x3_bn_relu(half, *args[1:7])
    with pytest.raises(ValueError):
        SK.scse_conv3x3_bn_relu([a["parts"][0], a["parts"][1][..., :-1]],
                                *args[1:7])
