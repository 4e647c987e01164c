"""Host-side pieces of the sm90 3×3 conv kernel (``ops/conv.py``), on the CPU.

The dispatch picks the kernel from dtype, width and alignment alone; the
B-operand weight arrangement, once its 128-byte swizzle is undone, rebuilds
the convolution as a plain matmul over im2col patches that agrees with
``F.conv2d`` (fp32 sums of bf16-rounded values: 1e-5 of max|ref|). Imports
no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eyediseasesegmentation_tpu_torch.ops import conv as CK


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
    wt = CK.sm90_weight_operand(w)
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
