"""Fused eval axial attention: the CUDA kernels' wrapper and its plain version.

Counterpart of ``eyediseasesegmentation_tpu/ops/axial_attention.py``. With
every BatchNorm folded into a per-channel affine, one axial attention is

    kq = affine(x_q @ W_kq);  v = affine(x_v @ W_v)
    qr[b,h,d,j] = Σ_i q·r_q ;  kr = Σ_i k·r_k ;  dots = Σ_i q·k
    logits = s0·qr + s1·kr + s2·dots + Σb   (folded joint-BN, per head)
    attn = softmax_j(logits)
    out = attn·v ; kv = attn·r_v
    y[b,L,(h,i)] = os0·kv + os1·out + Σob   (folded output-BN merge)

Sequences are (b, L, C), as in the JAX package. A tensor on the CPU takes
:func:`axial_attention_reference`; a CUDA tensor launches a kernel of
``csrc/axial_attention.cu`` (built on first use) or raises.

Two kernels, chosen by :func:`variant` from the dtype and the shapes alone:
``"sm90"`` (bf16, any L from 1 to 64, dkq 8, 4 or 8 heads, dv of 8, 16, 32
or 64, channel counts of multiples of 8, 16-byte-aligned inputs, a block that
fits in shared memory: ``csrc/axial_sm90.cuh``, the projection on TMA + wgmma
and the attention products on ``mma.sync``; sequences padded to 32 or 64
with the padded keys masked) and ``"wmma"`` (fp32, and other shapes: the
first kernel, wmma projection and attention on the FMA units). A non-zero
return code raises; nothing falls back to the other kernel.

Both kernels keep r_q and r_k in fp32 and round r_v and the attention
weights to the compute dtype, as the Pallas kernel does; the plain version,
like the JAX package's ``_folded_jnp``, rounds all three r tables.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_F32 = torch.float32

# Where the wrapper launches a kernel, and nowhere else: the total and each
# variant's count.
launches = 0
launches_sm90 = 0
launches_wmma = 0

_SMEM_LIMIT = 232448      # bytes of shared memory one block may use on sm_90
_MAX_L, _MAX_DKQ, _MAX_GROUP = 64, 16, 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the sm90 kernel (csrc/axial_sm90.cuh): rows per block, K per chunk,
# columns per warpgroup tile, warpgroups, ring stages
_S90_M, _S90_KC, _S90_NT, _S90_WG, _S90_STAGES = 64, 64, 64, 2, 4
_S90_TILE = _S90_M * _S90_KC * 2


def _split_packed(w_kq, w_v, kq_aff, v_aff, heads, dkq):
    """Self-attention passes ``w_v=None``: split the packed qkv projection.
    Channels are q_idx·H + h, so the q,k columns [0, 2·dkq·H) come first."""
    if w_v is not None:
        return w_kq, w_v, kq_aff, v_aff
    split = 2 * dkq * heads
    s, b = kq_aff
    return (w_kq[:, :split], w_kq[:, split:],
            (s[:split], b[:split]), (s[split:], b[split:]))


def axial_attention_reference(x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k,
                              r_v, logit_aff, out_aff, *, heads: int,
                              dkq: int, dv: int, dtype=torch.bfloat16):
    """Plain PyTorch version (the JAX package's ``_folded_jnp``)."""
    w_kq, w_v, kq_aff, v_aff = _split_packed(w_kq, w_v, kq_aff, v_aff,
                                             heads, dkq)
    H = heads
    kq = (x_q.to(dtype) @ w_kq.to(dtype)).to(_F32)
    kq = kq * kq_aff[0] + kq_aff[1]
    v = (x_v.to(dtype) @ w_v.to(dtype)).to(_F32)
    v = v * v_aff[0] + v_aff[1]
    b, L, _ = kq.shape
    kq = kq.reshape(b, L, 2 * dkq, H).to(dtype)
    q, k = kq[:, :, :dkq], kq[:, :, dkq:]
    v = v.reshape(b, L, dv, H).to(dtype)

    qr = torch.einsum("bdih,idj->bhdj", q, r_q.to(dtype)).to(_F32)
    kr = torch.einsum("bdih,idj->bhdj", k, r_k.to(dtype)).to(_F32)
    dots = torch.einsum("bdih,bjih->bhdj", q, k).to(_F32)
    ls = logit_aff[0].reshape(H, 3)
    lb = logit_aff[1].reshape(H, 3)
    logits = (qr * ls[None, :, 0, None, None] + kr * ls[None, :, 1, None, None]
              + dots * ls[None, :, 2, None, None]
              + lb.sum(-1)[None, :, None, None])
    attn = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhdj,bjih->bhid", attn, v).to(_F32)
    kv = torch.einsum("bhdj,idj->bhid", attn, r_v.to(dtype)).to(_F32)
    os_ = out_aff[0].reshape(2, H, dv)
    ob = out_aff[1].reshape(2, H, dv)
    merged = (kv * os_[0][None, :, :, None] + out * os_[1][None, :, :, None]
              + (ob[0] + ob[1])[None, :, :, None])
    # (b, H, i, d) -> (b, d, H*i)
    return merged.permute(0, 3, 1, 2).reshape(b, L, H * dv).to(dtype)


def _pad_to(x: int, m: int, r: int) -> int:
    """The least y >= x with y % m == r."""
    return x + (r - x) % m


@functools.lru_cache(maxsize=None)
def sm90_smem(L: int, heads: int, dv: int, cq: int, cv: int,
              self_attn: bool) -> int:
    """Bytes of dynamic shared memory of one block of the sm90 kernel
    (``k1::make_plan`` in ``csrc/axial_sm90.cuh``, which the launch checks),
    sized by the length the kernel pads L to (``k1::padded_len``)."""
    Lp = 32 if L <= 32 else 64
    nkq, nv = 16 * heads, heads * dv
    segs = [(cq, nkq + nv)] if self_attn else [(cq, nkq), (cv, nv)]
    per_pass = _S90_WG * _S90_NT
    resident, stream, tiles = 0, False, 1
    for k, n in segs:
        if -(-n // per_pass) > 1:     # several passes: x stays resident
            resident = max(resident, -(-k // _S90_KC) * _S90_TILE)
        else:
            stream = True
        tiles = max(tiles, min(_S90_WG, -(-n // _S90_NT)))
    proj = resident + _S90_STAGES * _S90_TILE * (tiles + int(stream))
    rows = 16 * (8 // heads)          # rows of one attention pass
    attn = rows * _pad_to(heads * (Lp + 8) // 2, 32, 4) * 4
    qrk = rows * _pad_to(heads * Lp, 32, 8) * 4
    z = rows * _pad_to(heads * (dv + 4), 32, 8) * 4
    region = -(-max(proj, attn + max(qrk, z)) // 1024) * 1024
    tiles_kq_v = _S90_M * (nkq + 8) * 2 + _S90_M * (nv + 8) * 2
    return 1024 + region + tiles_kq_v + 2 * _S90_STAGES * 8


def variant(dtype, L: int, heads: int, dkq: int, dv: int, cq: int, cv: int,
            data_ptrs, self_attn: bool) -> str:
    """The kernel that takes these shapes: ``"sm90"`` for bf16 with any L
    from 1 to 64 (padded to 32 or 64 in the kernel, the padded keys
    masked), dkq 8, 4 or 8 heads, dv of 8, 16, 32 or 64, channel counts of
    multiples of 8 and 16-byte-aligned inputs (what the TMA reads), where
    one block fits in shared memory; else ``"wmma"`` (fp32, L past 64 and
    the other shapes)."""
    if (dtype == torch.bfloat16 and 1 <= L <= _MAX_L and dkq == 8
            and heads in (4, 8) and dv in (8, 16, 32, 64)
            and cq % 8 == 0 and cv % 8 == 0
            and all(p % 16 == 0 for p in data_ptrs)
            and sm90_smem(L, heads, dv, cq, cv, self_attn) <= _SMEM_LIMIT):
        return "sm90"
    return "wmma"


def axial_attention(x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k, r_v,
                    logit_aff, out_aff, *, heads: int, dkq: int, dv: int,
                    dtype=torch.bfloat16):
    """Eval-path axial attention with folded norms.

    Self-attention: pass ``w_v=None`` with ``w_kq`` holding the packed qkv
    projection. Returns (b, L, heads·dv) in ``dtype``, head-major channels.
    Raises under grad mode when an input requires grad (no backward).
    """
    _build.refuse_autograd("axial_attention", x_q, x_v, w_kq, w_v, kq_aff,
                           v_aff, r_q, r_k, r_v, logit_aff, out_aff)
    if x_q.device.type == "cpu":
        return axial_attention_reference(
            x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k, r_v, logit_aff,
            out_aff, heads=heads, dkq=dkq, dv=dv, dtype=dtype)
    if x_q.device.type != "cuda":
        raise RuntimeError(f"axial_attention: no kernel for device "
                           f"{x_q.device}")
    global launches, launches_sm90, launches_wmma
    lib = _build.load("axial_attention")
    dev = x_q.device
    with torch.cuda.device(dev):
        rc, out, var = _run(lib, torch.cuda.current_stream(dev).cuda_stream,
                            x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k, r_v,
                            logit_aff, out_aff, heads, dkq, dv, dtype)
    if rc != 0:
        raise RuntimeError(f"axial_attention {var} kernel failed to launch: "
                           f"CUDA error {rc} (out {tuple(out.shape)})")
    launches += 1
    if var == "sm90":
        launches_sm90 += 1
    else:
        launches_wmma += 1
    return out


def _smem_plan(L: int, heads: int, dkq: int, dv: int, elem: int):
    """The wmma kernel's (row stride of the projected tile, its bytes,
    head-group size, total dynamic shared memory) for one block, mirroring
    its layout."""
    cols = heads * (2 * dkq + dv)
    words = -(-cols * elem // 4)
    if words % 2 == 0:          # odd word stride: rows fall on distinct banks
        words += 1
    ldp = words * 4 // elem
    p_bytes = -(-L * ldp * elem // 128) * 128
    staging = (2 * (_MAX_L * 40 * 2 + 32 * 136 * 2) + _MAX_L * 132 * 4
               if elem == 2 else _MAX_L * 33 * 4 + 32 * 128 * 4)
    for group in range(min(heads, _MAX_GROUP), 0, -1):
        if heads % group:
            continue
        smem = p_bytes + max(staging, group * L * (L + 1) * 4)
        if smem <= _SMEM_LIMIT:
            return ldp, p_bytes, group, smem
    raise ValueError(f"axial_attention: L={L}, heads={heads}, dkq={dkq}, "
                     f"dv={dv} does not fit in one block's shared memory")


def _head_major(heads: int, per_head: int, device):
    """Column permutation from interleaved (idx·H + h) to head-major, made on
    the device (a host copy would wait for the stream)."""
    idx = torch.arange(per_head, device=device)[None, :] * heads
    return (idx + torch.arange(heads, device=device)[:, None]).reshape(-1)


def _run(lib, stream, x_q, x_v, w_kq, w_v, kq_aff, v_aff, r_q, r_k, r_v,
         logit_aff, out_aff, heads, dkq, dv, dtype, force=None):
    """Marshal one call of ``lib``'s kernel that :func:`variant` picks (or
    ``force``); returns (cudaError_t, output, variant)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"axial_attention kernel: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    self_attn = w_v is None
    b, L, cq = x_q.shape
    cv = x_v.shape[-1]
    if x_v.shape[:2] != (b, L):
        raise ValueError(f"x_v {tuple(x_v.shape)} does not match x_q "
                         f"{tuple(x_q.shape)}")
    if not (1 <= L <= _MAX_L and 1 <= dkq <= _MAX_DKQ):
        raise ValueError(f"axial_attention kernel: needs L <= {_MAX_L} and "
                         f"dkq <= {_MAX_DKQ}, got L={L}, dkq={dkq}")
    nkq, nv = heads * 2 * dkq, heads * dv
    w_ok = (tuple(w_kq.shape) == (cq, nkq + nv) if self_attn else
            tuple(w_kq.shape) == (cq, nkq) and tuple(w_v.shape) == (cv, nv))
    if (not w_ok or tuple(r_q.shape) != (dkq, L, L)
            or tuple(r_k.shape) != (dkq, L, L)
            or tuple(r_v.shape) != (dv, L, L)):
        raise ValueError("axial_attention kernel: weight shapes do not match "
                         f"heads={heads}, dkq={dkq}, dv={dv}, L={L}")
    dev = x_q.device

    def f32(t):
        return t.to(device=dev, dtype=_F32).contiguous()

    def cdt(t):
        return t.to(device=dev, dtype=dtype).contiguous()

    xq, xv = cdt(x_q), cdt(x_v)
    var = force or variant(dtype, L, heads, dkq, dv, cq, cv,
                           [xq.data_ptr(), xv.data_ptr()], self_attn)
    out = torch.empty((b, L, nv), dtype=dtype, device=dev)

    if var == "sm90":
        # the weights in the module's own layouts, fp32; the library lays
        # them out for the kernel in `scratch`
        segs = [(xq, f32(w_kq), f32(kq_aff[0]), f32(kq_aff[1]))]
        segs.append((None,) * 4 if self_attn else
                    (xv, f32(w_v), f32(v_aff[0]), f32(v_aff[1])))
        scratch = torch.empty(
            lib.axial_attention_sm90_scratch(L, cq, cv, heads, dv,
                                             int(self_attn)),
            dtype=torch.uint8, device=dev)
        rest = [f32(r_q), f32(r_k), f32(r_v), scratch, f32(logit_aff[0]),
                f32(logit_aff[1]), f32(out_aff[0]), f32(out_aff[1]), out]
        ptrs = [None if t is None else t.data_ptr()
                for t in [*segs[0], *segs[1], *rest]]
        rc = lib.axial_attention_sm90_fwd(
            *ptrs, b, L, cq, cv, heads, dv, int(self_attn),
            ctypes.c_void_p(stream))
        del segs, rest   # alive until the launch was enqueued
        return rc, out, var

    w_kq, w_v, kq_aff, v_aff = _split_packed(w_kq, w_v, kq_aff, v_aff,
                                             heads, dkq)
    elem = torch.empty((), dtype=dtype).element_size()
    ldp, p_bytes, group, smem = _smem_plan(L, heads, dkq, dv, elem)
    # head-major projection columns (head access is then a contiguous slice)
    perm_kq = _head_major(heads, 2 * dkq, dev)
    perm_v = _head_major(heads, dv, dev)
    wkq, wv = cdt(w_kq[:, perm_kq]), cdt(w_v[:, perm_v])
    kqs, kqb = f32(kq_aff[0][perm_kq]), f32(kq_aff[1][perm_kq])
    vs, vb = f32(v_aff[0][perm_v]), f32(v_aff[1][perm_v])
    # fold the logit / output affines outside the kernel
    ls = f32(logit_aff[0]).reshape(heads, 3)
    ls0, ls1, ls2 = (ls[:, i].contiguous() for i in range(3))
    lbs = f32(logit_aff[1]).reshape(heads, 3).sum(-1).contiguous()
    os_ = f32(out_aff[0]).reshape(2, heads * dv)
    os0, os1 = os_[0].contiguous(), os_[1].contiguous()
    obs = f32(out_aff[1]).reshape(2, heads * dv).sum(0).contiguous()
    rq, rk = f32(r_q), f32(r_k)
    rvt = cdt(r_v.permute(1, 2, 0))           # (d, j, i)

    def vec_ok(x, w, k, n):      # 16-byte staging loads in the kernel
        return (elem == 2 and k % 8 == 0 and n % 8 == 0
                and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)

    vec = int(vec_ok(xq, wkq, cq, nkq)) | (int(vec_ok(xv, wv, cv, nv)) << 1)
    ptrs = [t.data_ptr() for t in (xq, xv, wkq, wv, kqs, kqb, vs, vb, rq, rk,
                                   rvt, ls0, ls1, ls2, lbs, os0, os1, obs,
                                   out)]
    rc = lib.axial_attention_fwd(
        _DTYPE_CODES[dtype], *ptrs, b, L, cq, cv, heads, dkq, dv, group,
        ldp, p_bytes, smem, vec, ctypes.c_void_p(stream))
    return rc, out, var
