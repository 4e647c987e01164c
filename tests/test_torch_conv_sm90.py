"""Host-side pieces of the sm90 3×3 conv kernels (``ops/conv.py``,
``ops/scse_conv.py``, ``ops/decode_pair.py``), on the CPU.

The dispatch picks the kernel from dtype, width and alignment alone (K4) and
from those and the parts' channel counts (K3, K2), and the wrappers hand the
picked variant and its operands to the library; the B-operand weight
arrangement, once its 128-byte swizzle is undone, rebuilds the convolution
as a plain matmul over im2col patches that agrees with ``F.conv2d`` (fp32
sums of bf16-rounded values: 1e-5 of max|ref|). Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eyediseasesegmentation_tpu_torch.ops import conv as CK
from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK


@pytest.mark.parametrize("dtype,width,ptr,want", [
    (torch.bfloat16, 512, 0x7f0000000000, "sm90"),
    (torch.bfloat16, 72, 0x7f0000000010, "sm90"),
    (torch.bfloat16, 36, 0x7f0000000000, "wmma"),    # rows of 72 bytes
    (torch.bfloat16, 512, 0x7f0000000008, "wmma"),   # base off 16 bytes
    (torch.float32, 512, 0x7f0000000000, "wmma"),    # the parity dtype
], ids=["bf16_w512", "bf16_w72", "bf16_w36", "bf16_misaligned", "fp32"])
def test_conv3x3_variant_is_chosen_by_dtype_width_alignment(dtype, width, ptr,
                                                            want):
    assert CK.variant(dtype, width, ptr) == want


_A, _B = 0x7f0000000000, 0x7f0000100010     # 16-byte-aligned bases


@pytest.mark.parametrize("dtype,width,ptrs,chs,want", [
    (torch.bfloat16, 512, [_A, _B], [256, 64], "sm90"),
    (torch.bfloat16, 256, [_A, _B, _A, _B], [128, 256, 256, 256], "sm90"),
    (torch.bfloat16, 72, [_B, _A], [32, 16], "sm90"),
    (torch.bfloat16, 512, [_A, _B], [256, 40], "wmma"),   # 40 % 16 != 0
    (torch.bfloat16, 512, [_A, _B + 8], [256, 64], "wmma"),  # misaligned
    (torch.bfloat16, 36, [_A, _B], [256, 64], "wmma"),    # rows of 72 bytes
    (torch.float32, 512, [_A, _B], [256, 64], "wmma"),    # the parity dtype
], ids=["bf16_x_3_3", "bf16_x_0_2", "bf16_w72", "bf16_part40",
        "bf16_misaligned", "bf16_w36", "fp32"])
def test_decode_node_variant_is_chosen_by_dtype_width_alignment_channels(
        dtype, width, ptrs, chs, want):
    assert SK.variant(dtype, width, ptrs, chs) == want
    assert PK.variant is SK.variant          # K2 and K3 decide alike


class _RecordingLib:
    """Stands in for a kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def decode_pair_tiles(self, variant, H, W):
        return 3

    def decode_pair_fwd(self, *args):
        self.calls.append(args)
        return 0

    def scse_conv3x3_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("kernel", ["scse_conv", "pair", "pair_up"])
@pytest.mark.parametrize("chs,dtype,want", [
    ([32, 16], torch.bfloat16, "sm90"),
    ([32, 40], torch.bfloat16, "wmma"),
    ([32, 16], torch.float32, "wmma"),
], ids=["bf16_16s", "bf16_part40", "fp32"])
def test_decode_node_wrappers_hand_the_variant_to_the_library(kernel, chs,
                                                              dtype, want):
    rng = np.random.RandomState(8)
    B, H, W, cout, C = 1, 6, 72, 24, sum(chs)

    def arr(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32))

    up0 = kernel == "pair_up"
    parts = [arr(B, c, H // 2 if (up0 and i == 0) else H, W).to(dtype)
             for i, c in enumerate(chs)]
    gate = (parts, torch.sigmoid(arr(B, C)), arr(C), arr(1)[0])
    k1, k2 = arr(cout, C, 3, 3), arr(cout, cout, 3, 3)
    lib = _RecordingLib()
    if kernel == "scse_conv":
        rc, out, var = SK._run(lib, None, *gate, k1, None, None, True, True)
        args = lib.calls[0]
    else:
        rc, out, _, var = PK._run(lib, None, *gate, k1, None, None, k2, None,
                                  None, True, True, up0)
        args = lib.calls[0]
        assert (args[16] is not None) == (want == "sm90")   # y1 scratch
    assert rc == 0 and var == want and args[1] == SK.VARIANTS[want]
    assert out.shape == (B, cout, H, W) and out.dtype == dtype
    coutP = args[-4]
    assert coutP == (64 if want == "sm90" else 32)


def _unswizzle(wt):
    """Undo the swizzle: piece j ^ (k % 8) of row k back to piece j."""
    k = torch.arange(wt.shape[-2])[:, None] % 8
    src = torch.arange(8)[None, :] ^ k
    pieces = wt.reshape(*wt.shape[:-1], 8, 8)
    out = torch.empty_like(pieces)
    out[..., torch.arange(wt.shape[-2])[:, None], src, :] = pieces
    return out.reshape(wt.shape)


@pytest.mark.parametrize("cin,cout", [(40, 80), (16, 64), (5, 12)])
def test_sm90_weight_operand_rebuilds_the_conv(cin, cout):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, cin, 6, 9).astype(np.float32))
    w = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
    wt = SK.sm90_weight_operand(w)
    npass, nchunk = -(-cout // 64), -(-cin // 16)
    assert wt.dtype == torch.bfloat16 and wt.is_contiguous()
    assert tuple(wt.shape) == (npass, nchunk, 9, 16, 64)
    # the swizzle moves whole 16-byte pieces, and only within a row
    assert not torch.equal(_unswizzle(wt), wt)
    # (npass, nchunk, tap, k, n) -> (tap, K, N) -> the im2col matrix
    b = _unswizzle(wt).float().permute(2, 1, 3, 0, 4).reshape(
        9, nchunk * 16, npass * 64)
    assert not b[:, cin:].any() and not b[:, :, cout:].any()
    b = b[:, :cin, :cout].reshape(9 * cin, cout)
    cols = F.unfold(x.bfloat16().float(), 3, padding=1)    # (B, cin*9, HW)
    cols = cols.view(2, cin, 9, -1).transpose(1, 2).reshape(2, 9 * cin, -1)
    got = torch.einsum("bkp,kn->bnp", cols, b).reshape(2, cout, 6, 9)
    ref = F.conv2d(x.bfloat16().float(), w.bfloat16().float(), padding=1)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()
