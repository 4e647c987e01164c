"""Port parity: the decode-node conv ops against the JAX package's kernels.

The same numpy-seeded inputs go through the JAX functions, run as the JAX
package's own tests run them on the CPU (Pallas interpret mode), and through
the port's plain versions, which the port's wrappers take for CPU tensors.
Maps are NHWC in JAX and NCHW in the port, conv weights HWIO and OIHW.

fp32 tolerances are the JAX tests' own against their plain composition:
3e-5 absolute on the maps (5e-5 with ``up_part0``: W then H interpolation
rounds once more than the 2-D one), and rtol 1e-5 / atol 2e-3 on the channel
sums. The bf16 case uses the JAX test's rtol 0.08 / atol 0.25: the two sides
round at the same points but sum in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyediseasesegmentation_tpu.ops.pallas_conv import (
    conv3x3_bn_relu as j_conv3x3_bn_relu)
from eyediseasesegmentation_tpu.ops.pallas_decode_pair import (
    scse_conv3x3_pair as j_scse_conv3x3_pair)
from eyediseasesegmentation_tpu.ops.pallas_scse_conv import (
    scse_conv3x3_bn_relu as j_scse_conv3x3_bn_relu)
from eyediseasesegmentation_tpu_torch.ops import conv as CK
from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

B, H, W = 2, 16, 32


def _make(seed, parts_ch, cout, up0=False, h=H):
    """Inputs in the JAX layout, as numpy fp32. With ``up0`` part 0 is drawn
    at (h/2, W/2) and upsampled along W."""
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    C = sum(parts_ch)
    parts = [arr(B, h, W, c) for c in parts_ch]
    if up0:
        low = torch.from_numpy(arr(B, h // 2, W // 2, parts_ch[0]))
        half = torch.nn.functional.interpolate(
            low.permute(0, 3, 1, 2), scale_factor=(1, 2), mode="bilinear",
            align_corners=False)
        parts[0] = half.permute(0, 2, 3, 1).contiguous().numpy()
    return dict(
        parts=parts, gate_c=1 / (1 + np.exp(-arr(B, C))),
        sse_k=arr(C, scale=0.3), sse_b=arr(1)[0],
        k1=arr(3, 3, C, cout, scale=0.1), s1=arr(cout), b1=arr(cout),
        k2=arr(3, 3, cout, cout, scale=0.1), s2=arr(cout, scale=0.5) + 1,
        b2=arr(cout, scale=0.1))


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dtype)


def _oihw(k):
    return torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()


def _nhwc(t):
    return t.to(torch.float32).permute(0, 2, 3, 1).numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("parts_ch,cout,relu,gated", [
    ([24, 8], 8, True, True),
    ([16, 8, 8], 48, True, True),
    ([32], 64, True, False),
    ([16, 16], 32, False, True),
], ids=["gated", "multi_part", "ungated", "linear"])
def test_scse_conv_matches_jax_kernel(parts_ch, cout, relu, gated):
    a = _make(cout, parts_ch, cout)
    want = j_scse_conv3x3_bn_relu(
        [jnp.asarray(p) for p in a["parts"]], jnp.asarray(a["gate_c"]),
        jnp.asarray(a["sse_k"]), jnp.asarray(a["sse_b"]), jnp.asarray(a["k1"]),
        jnp.asarray(a["s1"]), jnp.asarray(a["b1"]), relu=relu, gated=gated,
        tile_rows=4, interpret=True)
    before = SK.launches
    got = SK.scse_conv3x3_bn_relu(
        [_nchw(p) for p in a["parts"]], _t(a["gate_c"]), _t(a["sse_k"]),
        _t(a["sse_b"]), _oihw(a["k1"]), _t(a["s1"]), _t(a["b1"]), relu=relu,
        gated=gated, tile_rows=4)
    assert SK.launches == before          # CPU tensors: the plain version
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=3e-5)


def test_scse_conv_identity_affine_matches_jax_kernel():
    a = _make(7, [16, 16], 32)
    want = j_scse_conv3x3_bn_relu(
        [jnp.asarray(p) for p in a["parts"]], jnp.asarray(a["gate_c"]),
        jnp.asarray(a["sse_k"]), jnp.asarray(a["sse_b"]), jnp.asarray(a["k1"]),
        None, None, relu=False, tile_rows=8, interpret=True)
    got = SK.scse_conv3x3_bn_relu(
        [_nchw(p) for p in a["parts"]], _t(a["gate_c"]), _t(a["sse_k"]),
        _t(a["sse_b"]), _oihw(a["k1"]), None, None, relu=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=3e-5)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_conv3x3_matches_jax_kernel(relu):
    a = _make(3, [24], 16)
    want = j_conv3x3_bn_relu(jnp.asarray(a["parts"][0]), jnp.asarray(a["k1"]),
                             jnp.asarray(a["s1"]), jnp.asarray(a["b1"]),
                             relu=relu, tile_rows=4, interpret=True)
    before = CK.launches
    got = CK.conv3x3_bn_relu(_nchw(a["parts"][0]), _oihw(a["k1"]),
                             _t(a["s1"]), _t(a["b1"]), relu=relu)
    assert CK.launches == before
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=3e-5)


def _pair_both(a, dtype=torch.float32, jdtype=jnp.float32, **kw):
    jkw = dict(kw)
    want = j_scse_conv3x3_pair(
        [jnp.asarray(p, jdtype) for p in a["parts"]], jnp.asarray(a["gate_c"]),
        jnp.asarray(a["sse_k"]), jnp.asarray(a["sse_b"]), jnp.asarray(a["k1"]),
        jnp.asarray(a["s1"]), jnp.asarray(a["b1"]), jnp.asarray(a["k2"]),
        jnp.asarray(a["s2"]), jnp.asarray(a["b2"]), interpret=True, **jkw)
    kw.pop("tile_rows", None)
    before = PK.launches
    got = PK.scse_conv3x3_pair(
        [_nchw(p, dtype) for p in a["parts"]], _t(a["gate_c"]), _t(a["sse_k"]),
        _t(a["sse_b"]), _oihw(a["k1"]), _t(a["s1"]), _t(a["b1"]),
        _oihw(a["k2"]), _t(a["s2"]), _t(a["b2"]), **kw)
    assert PK.launches == before
    return got, want


@pytest.mark.parametrize("parts_ch,cout,h,gated,tile", [
    ([24, 8], 8, H, True, 4),
    ([16, 8, 8], 48, H, True, 4),
    ([24, 8], 16, H, False, 4),
    ([8, 8], 16, 6, True, 6),
], ids=["gated", "multi_part", "ungated", "single_chunk"])
def test_decode_pair_matches_jax_kernel(parts_ch, cout, h, gated, tile):
    a = _make(cout + h, parts_ch, cout, h=h)
    (y2, csum), (jy2, jcsum) = _pair_both(a, gated=gated, tile_rows=tile)
    assert csum.dtype == torch.float32 and tuple(csum.shape) == (B, cout)
    np.testing.assert_allclose(_nhwc(y2), np.asarray(jy2), rtol=0, atol=3e-5)
    np.testing.assert_allclose(csum.numpy(), np.asarray(jcsum), rtol=1e-5,
                               atol=2e-3)


@pytest.mark.parametrize("parts_ch,cout,h,gated,tile", [
    ([24, 8], 8, H, True, 4),
    ([8, 8], 16, 8, True, 8),
    ([16, 8], 16, H, False, 4),
], ids=["gated", "single_chunk", "ungated"])
def test_decode_pair_up_part0_matches_jax_kernel(parts_ch, cout, h, gated,
                                                 tile):
    a = _make(cout + h + 1, parts_ch, cout, up0=True, h=h)
    (y2, csum), (jy2, jcsum) = _pair_both(a, gated=gated, tile_rows=tile,
                                          up_part0=True)
    assert tuple(y2.shape) == (B, cout, h, W)
    np.testing.assert_allclose(_nhwc(y2), np.asarray(jy2), rtol=0, atol=5e-5)
    np.testing.assert_allclose(csum.numpy(), np.asarray(jcsum), rtol=1e-5,
                               atol=2e-3)


def test_decode_pair_bf16_close_to_jax_kernel():
    a = _make(11, [16, 8], 32)
    (y2, csum), (jy2, _) = _pair_both(a, dtype=torch.bfloat16,
                                      jdtype=jnp.bfloat16, tile_rows=8)
    assert y2.dtype == torch.bfloat16 and csum.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(y2), np.asarray(jy2, np.float32),
                               rtol=0.08, atol=0.25)


def test_wrappers_refuse_other_devices():
    a = _make(1, [8], 8)
    x = _nchw(a["parts"][0]).to("meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        CK.conv3x3_bn_relu(x, _oihw(a["k1"]))
