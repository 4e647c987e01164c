// K1's bf16 path for Hopper (sm_90a): fused eval axial attention with the
// projection on TMA + wgmma and every attention product on the tensor cores
// (mma.sync). axial_attention.cu includes it beside the first kernel, which
// keeps fp32 and the shapes this one does not take.
//
// Replaces: eyediseasesegmentation_tpu/ops/axial_attention.py, `_kernel`
// (the Pallas TPU kernel behind `axial_attention`), and rounds where it
// rounds: kq and v bf16 after their fp32 affine; qr and kr fp32 products of
// bf16 q, k with fp32 r_q, r_k; fp32 logits and softmax; the weights bf16;
// out = attn . v and kv = attn . r_v (r_v rounded to bf16) bf16 products
// with fp32 sums; the merge fp32, then rounded.
//
// What bounds it: at the largest main-path call (L = 64, C = 512, 8 heads of
// dkq 8 and dv 64, 1536 sequences) the projection is 64 GFLOP and the
// attention 15 GFLOP against 203 MB of device memory, so the floor is the
// tensor cores' 0.08 ms. The first kernel ran at 37x that: its projection on
// wmma re-staged x for every 128-column pass, its attention products ran on
// the FMA units, and a 130 KB fp32 slab of logits kept one block per SM.
// The design:
//   - a block owns 64 rows: any L up to 64 is padded to Lp = 32 or 64, and
//     a block takes S = 64 / Lp sequences (one of 64, or two of 32 packed
//     into one M tile of wgmma). x lands through a 3-D tensor map (K, L, b)
//     in boxes of (64, Lp, S), so the rows d >= L of a sequence and the
//     sequences past b are the TMA's zero fill, never stale shared memory;
//     the logits of keys j >= L are -inf before the row max (weight exactly
//     0), the r tables are laid out at Lp with zeros past L, padded rows are
//     computed but not stored, and a pass whose rows are all padding is
//     skipped;
//   - the projection [kq | v] = x . W runs on two consumer warpgroups, each
//     a 64 x 64 tile of columns per pass (wgmma m64n64k16, both operands
//     K-major with the 128-byte swizzle, fp32 sums in registers), fed by one
//     producer warp through a ring of 4 TMA stages of 64 x 64 boxes of x and
//     of W^T. Where the product takes several passes (self-attention: 640
//     columns at layer4), x lands once in a resident area and only W
//     streams, so x is read from device memory once per block; the affine
//     is the epilogue, which writes the bf16 kq and v tiles to shared
//     memory, head-major;
//   - the weights arrive as the module holds them and a first small kernel
//     (arrange_kernel) lays them out for this one in a scratch buffer: W^T
//     bf16 with its columns head-major and their affine beside it, r_q and
//     r_k interleaved per (d, j), and r_v in bf16 in mma.sync's register
//     order, so that every read of the main kernel is 16 bytes wide or a
//     pair; it moves about 3 MB at layer4, and with bf16 inputs and fp32
//     weights the wrapper launches no PyTorch kernel beside it;
//   - the attention runs in passes of 16 rows (8 heads) or 32 rows (4
//     heads), one warp per head and 16-row tile. qr, kr and the bias of the
//     logits are fp32 FMAs of all 256 consumer threads, each (d, j) entry of
//     r_q and r_k read once per pass and used for every head; dots = q . k^T
//     is mma m16n8k8 (K = dkq = 8); the softmax is fp32 in the fragment's
//     registers, and its bf16 weights are at once the A operand of out =
//     attn . v (mma m16n8k16, v through ldmatrix.trans) and, through shared
//     memory, the B operand of kv: for each query position d one (dv x L) .
//     (L x heads) product, so that r_v[:, d, :] is read once per pass for
//     every head. kv's merge terms meet out's through shared memory, and the
//     merged rows are stored as bf16 pairs. With one block an SM (dv >= 32)
//     the logit terms and kv wait on L2: there a thread loads the r entries
//     of 4 positions, and a warp the r_v fragments of 4 products, before it
//     uses them;
//   - no fp32 logit slab: a pass keeps its logit terms (32 KB at layer4) and
//     its weights (18 KB) in the area the ring used. At layer4 the resident
//     x (64 KB), the ring (64 KB) and the kq, v tiles (82 KB) keep one block
//     on an SM; the cross-attention shapes (about 80 KB) take two, so one
//     block's projection overlaps the other's attention.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <sm90.cuh>

#include "tensor_map.cuh"

// How the kernel is launched. A host-side emulation of the device code may
// define it otherwise.
#ifndef K1_LAUNCH
#define K1_LAUNCH(kernel, grid, threads, smem, stream, params) \
  kernel<<<grid, threads, smem, stream>>>(params)
#endif
// Blocks of 256 threads for each job of arrange_kernel (a grid-stride loop:
// a host-side emulation may run fewer).
#ifndef K1_ARRANGE_BLOCKS
#define K1_ARRANGE_BLOCKS 64
#endif

namespace k1 {

using bf16 = __nv_bfloat16;

constexpr int kM = 64;                      // rows of a block
constexpr int kKC = 64;                     // K of a chunk: one 128-byte line
constexpr int kNT = 64;                     // columns of a warpgroup's tile
constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kStages = 4;
constexpr int kCWarps = 4 * kWG;
constexpr int kConsumers = 32 * kCWarps;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTile = kM * kKC * 2;         // one 64 x 64 bf16 box: 8 KB
constexpr int kBar = 1;                     // named barrier of the consumers
constexpr int kSmemLimit = 232448;          // bytes a block may use on sm_90

// One product of the projection: head-major columns [col0, col0 + N) of
// [kq | v] from x (b, L, K) and W (K, N).
struct Seg {
  CUtensorMap x;       // (K, L, b) of x, box (64, Lp, 64 / Lp), 128-byte swizzle
  CUtensorMap w;       // (K, N) of W^T, box (64, 64), 128-byte swizzle
  const float* aff;    // (2, N): scale, then bias
  int N, col0, nchunk, npass, resident;
};

// Byte offsets of a block's shared memory from its 1024-aligned base, and
// row strides. The ring's area (resident x, then the stages) is the
// attention's afterwards: a pass's weights, then its logit terms or its
// merge terms.
struct Plan {
  int ring, stage, xstream;  // first stage, bytes a stage, W's offset in it
  int attn, qz;              // the attention pass's areas
  int kq, v, bars, total;
  int ldkq, ldv;             // row strides of the kq and v tiles (values)
  int lda;                   // a row's weights (32-bit words; head h at h * (Lp + 8) / 2)
  int ldq, ldz, dvs;         // a row's logit terms (head h at h * Lp) and
                             // merge terms (head h at h * dvs), floats
  int rg;                    // rows of one attention pass
};

struct Params {
  Seg seg[2];
  int nseg;
  const float* rqk;          // (Lp, Lp, 16): r_q[0..7][d][j], then r_k
  const uint4* rvf;          // r_v's fragments: (Lp, dv / 16, Lp / 16, 32)
  const float* lsc;          // (3 H,): the folded logit affine, per head
  const float* lbi;          // the scales of qr, kr, dots; their biases
  const float* osc;          // (2 H dv,): the folded output affine, kv's
  const float* obi;          // head-major channels, then out's
  bf16* out;                 // (b, L, H * dv)
  int b, L, heads;           // sequences, their true length, heads
  Plan plan;
};

inline int pad_to(int x, int m, int r) { return x + ((r - x) % m + m) % m; }

// The shared-memory plan at the padded length Lp (ops/axial_attention.py
// `sm90_smem` mirrors it). Strides are padded so that the fragments'
// accesses fall on distinct banks.
inline Plan make_plan(int Lp, int H, int dv, const Seg* seg, int nseg) {
  Plan q{};
  int resident = 0, tiles = 1;
  bool stream = false;
  for (int s = 0; s < nseg; ++s) {
    if (seg[s].resident)
      resident = resident > seg[s].nchunk * kTile ? resident
                                                  : seg[s].nchunk * kTile;
    else
      stream = true;
    const int t = (seg[s].N + kNT - 1) / kNT;
    tiles = tiles > (t < kWG ? t : kWG) ? tiles : (t < kWG ? t : kWG);
  }
  q.ring = resident;
  q.xstream = stream ? kTile : 0;
  q.stage = q.xstream + tiles * kTile;
  const int proj = resident + kStages * q.stage;
  q.rg = 16 * (8 / H);
  q.lda = pad_to(H * (Lp + 8) / 2, 32, 4);
  q.ldq = pad_to(H * Lp, 32, 8);
  q.dvs = dv + 4;
  q.ldz = pad_to(H * q.dvs, 32, 8);
  q.attn = 0;
  q.qz = q.rg * q.lda * 4;
  const int att = q.qz + q.rg * (q.ldq > q.ldz ? q.ldq : q.ldz) * 4;
  q.kq = ((proj > att ? proj : att) + 1023) / 1024 * 1024;
  q.ldkq = 16 * H + 8;
  q.ldv = H * dv + 8;
  q.v = q.kq + kM * q.ldkq * 2;
  q.bars = q.v + kM * q.ldv * 2;
  q.total = 1024 + q.bars + 2 * kStages * 8;
  return q;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The producer warp's lane 0: every box of every chunk, in the order the
// consumers take them, into the ring (x into the resident area on the first
// pass of a product that takes several). x's box is the block's sequences
// from seq0 on.
__device__ __forceinline__ void produce(const Params& p, unsigned char* base,
                                        uint64_t* full, uint64_t* empty,
                                        int seq0) {
  const Plan& q = p.plan;
  int it = 0;
  for (int s = 0; s < p.nseg; ++s) {
    const Seg& g = p.seg[s];
    for (int pass = 0; pass < g.npass; ++pass) {
      const int n0 = pass * kWG * kNT;
      const int t = (g.N - n0 + kNT - 1) / kNT;
      const int tiles = t < kWG ? t : kWG;
      const bool loadx = !g.resident || pass == 0;
      for (int kc = 0; kc < g.nchunk; ++kc, ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = base + q.ring + st * q.stage;
        sm90::mbar_arrive_expect_tx(&full[st],
                                    (tiles + (loadx ? 1 : 0)) * kTile);
        if (loadx)
          sm90::tma_load_3d(g.resident ? base + kc * kTile : stage, &g.x,
                            &full[st], kc * kKC, 0, seq0);
        for (int j = 0; j < tiles; ++j)
          sm90::tma_load_2d(stage + q.xstream + j * kTile, &g.w, &full[st],
                            kc * kKC, n0 + j * kNT);
      }
    }
  }
}

// The consumers' projection: warpgroup wg takes columns [n0, n0 + 64) of
// each pass; the epilogue writes bf16(acc * scale + bias) to the kq or v
// tile.
__device__ __forceinline__ void project(const Params& p, unsigned char* base,
                                        uint64_t* full, uint64_t* empty,
                                        bf16* KQ, bf16* V) {
  const Plan& q = p.plan;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int wl = t / 32, lane = t % 32;
  const int nkq = 16 * p.heads;
  // K-major operands: 64 rows of 128-byte lines (64 K values), a k16 step
  // 32 bytes further, groups of 8 rows 1024 bytes apart; one swizzle atom
  // along K, so the leading byte offset is never used (it is given the same
  // value)
  constexpr uint32_t kSBO = 1024;
  int it = 0;
  for (int s = 0; s < p.nseg; ++s) {
    const Seg& g = p.seg[s];
    for (int pass = 0; pass < g.npass; ++pass) {
      const int n0 = (pass * kWG + wg) * kNT;
      const bool active = n0 < g.N;
      float acc[32];  // set by the first product (accumulate = 0)
      for (int kc = 0; kc < g.nchunk; ++kc, ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&full[st], (it / kStages) & 1);
        __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
        if (active) {
          const unsigned char* stage = base + q.ring + st * q.stage;
          const unsigned char* xa = g.resident ? base + kc * kTile : stage;
          const unsigned char* wb = stage + q.xstream + wg * kTile;
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKC / 16; ++kk)
            sm90::wgmma_m64n64k16_bf16<0, 0>(
                acc, sm90::desc_sw128(xa + 32 * kk, kSBO, kSBO),
                sm90::desc_sw128(wb + 32 * kk, kSBO, kSBO), kc > 0 || kk > 0);
          sm90::wgmma_commit();
          // the previous chunk's products are done: release its stage
          sm90::wgmma_wait<1>();
          if (kc > 0 && t == 0)
            sm90::mbar_arrive(&empty[(it - 1) % kStages]);
        } else if (t == 0) {
          sm90::mbar_arrive(&empty[st]);
        }
      }
      if (!active) continue;
      sm90::wgmma_wait<0>();
      if (t == 0) sm90::mbar_arrive(&empty[(it - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = 16 * wl + lane / 4 + 8 * ((i >> 1) & 1);
        const int n = n0 + 8 * (i >> 2) + 2 * (lane & 3);
        if (n < g.N) {
          const int c = g.col0 + n;
          const float2 sc = *reinterpret_cast<const float2*>(g.aff + n);
          const float2 bi = *reinterpret_cast<const float2*>(g.aff + g.N + n);
          bf16* dst = c < nkq ? KQ + m * q.ldkq + c : V + m * q.ldv + (c - nkq);
          *reinterpret_cast<uint32_t*>(dst) =
              pack2(acc[i] * sc.x + bi.x, acc[i + 1] * sc.y + bi.y);
        }
      }
    }
  }
}

// The attention of the block's 64 rows (tile row r is position r % LP of
// sequence seq0 + r / LP), in passes of rg rows: warp w takes head w % H on
// the 16 rows 16 (w / H) of a pass. A pass lies in one sequence (rg <= LP).
template <int LP, int DV>
__device__ __forceinline__ void attend(const Params& p, unsigned char* base,
                                       const bf16* KQ, const bf16* V,
                                       int seq0) {
  constexpr int NT = LP / 8, KT = LP / 16, DT = DV / 8, MI = (DV + 15) / 16;
  constexpr int AH = (LP + 8) / 2;  // words of one head's weights in a row
  const Plan& q = p.plan;
  const int H = p.heads, nv = H * DV, L = p.L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int h = warp % H, mt = warp / H;
  uint32_t* At = reinterpret_cast<uint32_t*>(base + q.attn);
  float* QZ = reinterpret_cast<float*>(base + q.qz);
  const float ls2 = p.lsc[3 * h + 2];

  for (int r0 = 0; r0 < kM; r0 += q.rg) {
    // rows that are all padding, or a sequence past b: nothing to store
    if (r0 % LP >= L || seq0 + r0 / LP >= p.b) continue;
    // 1. the logits' fp32 terms of every head, ls0 qr + ls1 kr + bias, at
    //    QZ[rr][h][j]: each (d, j) entry of r_q and r_k is read once; at dv
    //    >= 32 (one block an SM) a thread loads the entries of kPos
    //    positions before it uses them
    constexpr int kPos = DV >= 32 ? 4 : 1;
    for (int e0 = tid; e0 < q.rg * LP; e0 += kPos * kConsumers) {
      float4 r4[kPos][4];
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        const int e = e0 + u * kConsumers;
        const float4* src = reinterpret_cast<const float4*>(
            p.rqk + (static_cast<size_t>((r0 + e / LP) % LP) * LP + e % LP) * 16);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          r4[u][v] = e < q.rg * LP ? src[v] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPos; ++u) {
        const int e = e0 + u * kConsumers;
        const int rr = e / LP, j = e % LP, m = r0 + rr;
        const float rq[8] = {r4[u][0].x, r4[u][0].y, r4[u][0].z, r4[u][0].w,
                             r4[u][1].x, r4[u][1].y, r4[u][1].z, r4[u][1].w};
        const float rk[8] = {r4[u][2].x, r4[u][2].y, r4[u][2].z, r4[u][2].w,
                             r4[u][3].x, r4[u][3].y, r4[u][3].z, r4[u][3].w};
        for (int hh = 0; hh < H && e < q.rg * LP; ++hh) {
          const bf16* qk = KQ + m * q.ldkq + 16 * hh;
          float qf[8], kf[8];
          unpack8(*reinterpret_cast<const uint4*>(qk), qf);
          unpack8(*reinterpret_cast<const uint4*>(qk + 8), kf);
          float qr = 0.f, kr = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            qr = fmaf(qf[i], rq[i], qr);
            kr = fmaf(kf[i], rk[i], kr);
          }
          const float* lb = p.lbi + 3 * hh;
          QZ[rr * q.ldq + hh * LP + j] = p.lsc[3 * hh] * qr +
                                        p.lsc[3 * hh + 1] * kr +
                                        (lb[0] + lb[1] + lb[2]);
        }
      }
    }
    sm90::bar_sync(kBar, kConsumers);

    // 2. head h on rows m0 .. m0 + 15 (one sequence, keys from row kb):
    //    dots on the tensor cores, the softmax in the fragment's registers,
    //    the weights rounded to bf16 into pa (out's A operand) and At (kv's
    //    B operand); keys j >= L are padding, with logits -inf
    const int ml = 16 * mt, m0 = r0 + ml, kb = (m0 / LP) * LP;
    const bf16* qrow = KQ + (m0 + g) * q.ldkq + 16 * h + 2 * c;
    const uint32_t qa0 = *reinterpret_cast<const uint32_t*>(qrow);
    const uint32_t qa1 = *reinterpret_cast<const uint32_t*>(qrow + 8 * q.ldkq);
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const uint32_t kb0 = *reinterpret_cast<const uint32_t*>(
          KQ + (kb + 8 * nt + g) * q.ldkq + 16 * h + 8 + 2 * c);
      sm90::mma_m16n8k8_bf16(sc[nt], qa0, qa1, kb0);
    }
    const float* qz0 = QZ + (ml + g) * q.ldq + h * LP + 2 * c;
    const float* qz1 = qz0 + 8 * q.ldq;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 t0 = *reinterpret_cast<const float2*>(qz0 + 8 * nt);
      const float2 t1 = *reinterpret_cast<const float2*>(qz1 + 8 * nt);
      sc[nt][0] = ls2 * sc[nt][0] + t0.x;
      sc[nt][1] = ls2 * sc[nt][1] + t0.y;
      sc[nt][2] = ls2 * sc[nt][2] + t1.x;
      sc[nt][3] = ls2 * sc[nt][3] + t1.y;
      if (L < LP) {
        const int j = 8 * nt + 2 * c;
        if (j >= L) sc[nt][0] = sc[nt][2] = -INFINITY;
        if (j + 1 >= L) sc[nt][1] = sc[nt][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    // a row's entries are spread over the 4 lanes of a quad
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mx0);
      sc[nt][1] = expf(sc[nt][1] - mx0);
      sc[nt][2] = expf(sc[nt][2] - mx1);
      sc[nt][3] = expf(sc[nt][3] - mx1);
      sum0 += sc[nt][0] + sc[nt][1];
      sum1 += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xFFFFFFFFu, sum0, o);
      sum1 += __shfl_xor_sync(0xFFFFFFFFu, sum1, o);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    uint32_t pa[KT][4];
    uint32_t* w0 = At + (ml + g) * q.lda + h * AH + c;
    uint32_t* w1 = w0 + 8 * q.lda;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      pa[kt][0] = pack2(sc[2 * kt][0] * inv0, sc[2 * kt][1] * inv0);
      pa[kt][1] = pack2(sc[2 * kt][2] * inv1, sc[2 * kt][3] * inv1);
      pa[kt][2] = pack2(sc[2 * kt + 1][0] * inv0, sc[2 * kt + 1][1] * inv0);
      pa[kt][3] = pack2(sc[2 * kt + 1][2] * inv1, sc[2 * kt + 1][3] * inv1);
      w0[8 * kt] = pa[kt][0];
      w0[8 * kt + 4] = pa[kt][2];
      w1[8 * kt] = pa[kt][1];
      w1[8 * kt + 4] = pa[kt][3];
    }
    sm90::bar_sync(kBar, kConsumers);

    // 3. kv for each row rr of the pass (position d): A_d = r_v[:, d, :]
    //    (dv x L, rows past dv zero) times the weights of every head (L x
    //    H), merged into QZ[rr][h][i] = os0 kv + both biases; r_v[:, d, :] is
    //    read once for every head. At dv >= 32 a warp loads the fragments of
    //    kItems items before it multiplies
    constexpr int kItems = DV >= 32 ? 4 : 1;
    const int items = q.rg * MI;
    for (int it0 = warp; it0 < items; it0 += kItems * kCWarps) {
      uint4 af[kItems][KT];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int item = it0 + u * kCWarps;
        const int d = (r0 + item / MI) % LP, mi = item % MI;
        const uint4* src =
            p.rvf + (static_cast<size_t>(d) * MI + mi) * KT * 32 + lane;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          af[u][kt] = item < items ? src[kt * 32] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int item = it0 + u * kCWarps;
        const int rr = item / MI, mi = item % MI;
        const uint32_t* brow = At + rr * q.lda + g * AH + c;
        const bool head = g < H && item < items;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t av[4] = {af[u][kt].x, af[u][kt].y, af[u][kt].z,
                                  af[u][kt].w};
          sm90::mma_m16n8k16_bf16(acc, av, head ? brow[8 * kt] : 0u,
                                  head ? brow[8 * kt + 4] : 0u);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mi + g + 8 * (e >> 1), hh = 2 * c + (e & 1);
          if (item < items && i < DV && hh < H)
            QZ[rr * q.ldz + hh * q.dvs + i] =
                p.osc[hh * DV + i] * acc[e] +
                (p.obi[hh * DV + i] + p.obi[nv + hh * DV + i]);
        }
      }
    }
    sm90::bar_sync(kBar, kConsumers);

    // 4. out = attn . v for head h on rows m0 .. m0 + 15, merged with kv's
    //    terms and stored as bf16 pairs
    float o[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    const bf16* vrow = V + (kb + (lane & 15)) * q.ldv + h * DV;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b[2];
        sm90::ldmatrix_x2_trans(b, vrow + 16 * kt * q.ldv + 8 * dt);
        sm90::mma_m16n8k16_bf16(o[dt], pa[kt], b[0], b[1]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int i = 8 * dt + 2 * c;
      const float s0 = p.osc[nv + h * DV + i], s1 = p.osc[nv + h * DV + i + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = ml + g + 8 * half, d = (r0 + rr) % LP;
        const float2 z =
            *reinterpret_cast<const float2*>(QZ + rr * q.ldz + h * q.dvs + i);
        if (d < L)   // the pass's sequence is below b
          *reinterpret_cast<uint32_t*>(
              p.out +
              (static_cast<size_t>(seq0 + r0 / LP) * L + d) * nv + h * DV + i) =
              pack2(z.x + s0 * o[dt][2 * half], z.y + s1 * o[dt][2 * half + 1]);
      }
    }
    sm90::bar_sync(kBar, kConsumers);  // the next pass reuses At and QZ
  }
}

// Blocks an SM should hold: two where dv <= 16 (the cross-attention shapes,
// about 80 KB of shared memory each), so one block's projection overlaps the
// other's attention; the bound keeps them at 112 registers a thread.
template <int DV>
constexpr int kBlocksPerSM = DV <= 16 ? 2 : 1;

template <int LP, int DV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<DV>)
    axial_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzle is a function of the address: operands start 1024-aligned
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const Plan& q = p.plan;
  bf16* KQ = reinterpret_cast<bf16*>(base + q.kq);
  bf16* V = reinterpret_cast<bf16*>(base + q.v);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + q.bars);
  uint64_t* empty = full + kStages;
  const int seq0 = blockIdx.x * (kM / LP);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWG);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(p, base, full, empty, seq0);
    return;
  }
  project(p, base, full, empty, KQ, V);
  sm90::bar_sync(kBar, kConsumers);  // the tiles are complete, the ring free
  attend<LP, DV>(p, base, KQ, V, seq0);
}

// The padded length of a sequence: 32 or 64.
inline int padded_len(int L) { return L <= 32 ? 32 : 64; }

// Where arrange_kernel puts the weights in the scratch buffer (bytes, each
// part 16-byte aligned): per product W^T (N, K) bf16 and its affine (2, N)
// fp32; rqk (Lp, Lp, 16) fp32; r_v's fragments.
struct Scratch {
  size_t wt[2], aff[2], rqk, rvf, total;
};

inline Scratch scratch_plan(int L, int cq, int cv, int heads, int dv,
                            bool self_attn) {
  const int Lp = padded_len(L);
  const auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const int nkq = 16 * heads, nv = heads * dv;
  const int K[2] = {cq, self_attn ? 0 : cv};
  const int N[2] = {self_attn ? nkq + nv : nkq, self_attn ? 0 : nv};
  Scratch sc{};
  size_t at = 0;
  for (int s = 0; s < 2; ++s) {
    sc.wt[s] = at;
    at += up16(static_cast<size_t>(N[s]) * K[s] * 2);
    sc.aff[s] = at;
    at += up16(static_cast<size_t>(N[s]) * 2 * 4);
  }
  sc.rqk = at;
  at += static_cast<size_t>(Lp) * Lp * 16 * 4;
  sc.rvf = at;
  at += static_cast<size_t>(Lp) * ((dv + 15) / 16) * 16 * Lp * 2;
  sc.total = at;
  return sc;
}

struct ArrangeParams {
  const float* w[2];      // the module's W (K, N), columns index * H + head
  const float* scale[2];  // (N,), the same order
  const float* bias[2];
  bf16* wt[2];            // W^T (N, K), rows head-major
  float* aff[2];          // (2, N), head-major
  int K[2], N[2], col0[2];
  const float* rq;        // (8, L, L)
  const float* rk;
  float* rqk;             // (Lp, Lp, 16), zeros past L
  const float* rv;        // (dv, L, L)
  uint4* rvf;
  int L, Lp, H, dv, nkq, n[4];  // work items of the four jobs
};

// Job blockIdx.x / K1_ARRANGE_BLOCKS: 0, 1 W^T and the affine of that
// product, one element a step, with column c of the head-major order read from column (c % 16)
// * H + c / 16 of kq, or (c % dv) * H + c / dv of v; 2 rqk; 3 r_v's
// fragments: for each query position d < Lp, A_d[i][j] = bf16(r_v[i][d][j])
// (i past dv zero) in 16 x 16 tiles, each in mma.sync m16n8k16's register
// order: rvf[d][i / 16][j / 16][lane] holds rows g, g + 8 and columns 2c,
// 2c + 1, 2c + 8, 2c + 9 of the tile as a0..a3 (g = lane / 4, c = lane % 4).
// Both tables are laid out at Lp, with zeros at d or j past L.
__global__ void arrange_kernel(const ArrangeParams a) {
  const int job = blockIdx.x / K1_ARRANGE_BLOCKS, L = a.L, Lp = a.Lp;
  const int step = K1_ARRANGE_BLOCKS * blockDim.x;
  for (int t = (blockIdx.x % K1_ARRANGE_BLOCKS) * blockDim.x + threadIdx.x;
       t < a.n[job]; t += step) {
    if (job < 2) {
      const int K = a.K[job], r = t / K, k = t % K, c = a.col0[job] + r;
      const int src = (c < a.nkq ? (c % 16) * a.H + c / 16
                                 : a.nkq + ((c - a.nkq) % a.dv) * a.H +
                                       (c - a.nkq) / a.dv) - a.col0[job];
      a.wt[job][t] =
          __float2bfloat16(a.w[job][static_cast<size_t>(k) * a.N[job] + src]);
      if (k == 0) {
        a.aff[job][r] = a.scale[job][src];
        a.aff[job][a.N[job] + r] = a.bias[job][src];
      }
    } else if (job == 2) {
      const int i = t % 16, j = (t / 16) % Lp, d = t / (16 * Lp);
      a.rqk[t] = d >= L || j >= L ? 0.f
                 : i < 8          ? a.rq[(i * L + d) * L + j]
                                  : a.rk[((i - 8) * L + d) * L + j];
    } else {
      const int MI = (a.dv + 15) / 16, KT = Lp / 16;
      const int lane = t % 32, kt = (t / 32) % KT, mi = (t / (32 * KT)) % MI;
      const int d = t / (32 * KT * MI), g = lane / 4, c = lane % 4;
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * mi + g + 8 * (r % 2);
        const int j = 16 * kt + 2 * c + 8 * (r / 2);
        const size_t at = (static_cast<size_t>(i) * L + d) * L + j;
        const bool row = i < a.dv && d < L;
        w[r] = pack2(row && j < L ? a.rv[at] : 0.f,
                     row && j + 1 < L ? a.rv[at + 1] : 0.f);
      }
      a.rvf[t] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// A bf16 tensor of `rank` dimensions (dims[0] contiguous), read by boxes of
// 64 values along dims[0] (one 128-byte line) with the 128-byte swizzle;
// coordinates past its edges read zeros.
inline bool encode_boxes(CUtensorMap* m, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint32_t* box) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[2];
  for (int i = 1; i < rank; ++i)
    strides[i - 1] = (i == 1 ? 2 : strides[i - 2]) * dims[i - 1];
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// W^T (N, K), by 64 x 64 boxes.
inline bool encode_rows(CUtensorMap* m, const void* base, int K, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {kKC, kM};
  return encode_boxes(m, base, 2, dims, box);
}

// x (b, L, K), by boxes of 64 x Lp x (64 / Lp): the rows d >= L of each
// sequence and the sequences past b are zeros.
inline bool encode_seqs(CUtensorMap* m, const void* base, int K, int L,
                        int b) {
  const int Lp = padded_len(L);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(b)};
  const cuuint32_t box[3] = {kKC, static_cast<cuuint32_t>(Lp),
                             static_cast<cuuint32_t>(kM / Lp)};
  return encode_boxes(m, base, 3, dims, box);
}

template <int LP, int DV>
cudaError_t launch(const Params& p, unsigned grid, cudaStream_t stream) {
  void (*kernel)(const Params) = axial_sm90_kernel<LP, DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.plan.total);
  if (err != cudaSuccess) return err;
  K1_LAUNCH(kernel, grid, kThreads, p.plan.total, stream, p);
  return cudaGetLastError();
}

inline cudaError_t launch_arrange(const ArrangeParams& a,
                                  cudaStream_t stream) {
  K1_LAUNCH(arrange_kernel, 4 * K1_ARRANGE_BLOCKS, 256, 0, stream, a);
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_dv(const Params& p, int dv, unsigned grid,
                      cudaStream_t stream) {
  switch (dv) {
    case 8: return launch<LP, 8>(p, grid, stream);
    case 16: return launch<LP, 16>(p, grid, stream);
    case 32: return launch<LP, 32>(p, grid, stream);
    case 64: return launch<LP, 64>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k1

// Bytes of the scratch buffer axial_attention_sm90_fwd needs.
extern "C" int axial_attention_sm90_scratch(int L, int cq, int cv, int heads,
                                            int dv, int self_attn) {
  return static_cast<int>(
      k1::scratch_plan(L, cq, cv, heads, dv, self_attn != 0).total);
}

// The sm90 variant (bf16), on the module's own layouts. Products:
// self-attention one, (x0 (b, L, cq), w0 the packed [W_kq | W_v] (cq, nkq +
// nv), s0, b0 its folded affine (nkq + nv,)); cross two, (x0, w0 = W_kq, s0,
// b0) and (x1 (b, L, cv), w1 = W_v, s1, b1); columns index * heads + head;
// W and the affines fp32, x bf16. rq, rk (8, L, L) and rv (dv, L, L) fp32;
// scratch of axial_attention_sm90_scratch bytes; lsc, lbi (3 heads,) and
// osc, obi (2 heads dv,) fp32, the folded logit and output affines; out (b,
// L, heads * dv), head-major. Takes L of 1 to 64, dkq 8, 4 or 8 heads, dv
// of 8, 16, 32 or 64, cq and cv multiples of 8, 16-byte-aligned x, scratch
// and out, and a block that fits in shared memory; cudaErrorInvalidValue
// for the rest. Any L from 1 to 64 runs padded to Lp = 32 or 64, 64 / Lp
// sequences a block. Returns the launches' cudaError_t.
extern "C" int axial_attention_sm90_fwd(
    const void* x0, const void* w0, const void* s0, const void* b0,
    const void* x1, const void* w1, const void* s1, const void* b1,
    const void* rq, const void* rk, const void* rv, void* scratch,
    const void* lsc, const void* lbi, const void* osc, const void* obi,
    void* out, int b, int L, int cq, int cv, int heads, int dv,
    int self_attn, void* stream) {
  using namespace k1;
  const auto aligned = [](const void* q) {
    return q != nullptr && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (b < 1 || L < 1 || L > 64 || (heads != 4 && heads != 8) ||
      (dv != 8 && dv != 16 && dv != 32 && dv != 64) || cq % 8 != 0 ||
      cv % 8 != 0 || !aligned(x0) || !aligned(scratch) || !aligned(out) ||
      (!self_attn && !aligned(x1)) ||
      static_cast<long long>(b) * 64 > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nkq = 16 * heads, nv = heads * dv, Lp = padded_len(L);
  const Scratch sc = scratch_plan(L, cq, cv, heads, dv, self_attn != 0);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  Params p{};
  ArrangeParams a{};
  p.nseg = self_attn ? 1 : 2;
  const void* xs[2] = {x0, x1};
  const void* ws[2] = {w0, w1};
  const void* ss[2] = {s0, s1};
  const void* bs[2] = {b0, b1};
  const int K[2] = {cq, cv};
  const int N[2] = {self_attn ? nkq + nv : nkq, nv};
  for (int s = 0; s < p.nseg; ++s) {
    Seg& g = p.seg[s];
    a.w[s] = static_cast<const float*>(ws[s]);
    a.scale[s] = static_cast<const float*>(ss[s]);
    a.bias[s] = static_cast<const float*>(bs[s]);
    a.wt[s] = reinterpret_cast<bf16*>(buf + sc.wt[s]);
    a.aff[s] = reinterpret_cast<float*>(buf + sc.aff[s]);
    a.K[s] = K[s];
    a.N[s] = N[s];
    a.col0[s] = s == 0 ? 0 : nkq;
    a.n[s] = N[s] * K[s];
    g.aff = a.aff[s];
    g.N = N[s];
    g.col0 = a.col0[s];
    g.nchunk = (K[s] + kKC - 1) / kKC;
    g.npass = (g.N + kWG * kNT - 1) / (kWG * kNT);
    g.resident = g.npass > 1;
    if (!encode_seqs(&g.x, xs[s], K[s], L, b) ||
        !encode_rows(&g.w, a.wt[s], K[s], g.N))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.rq = static_cast<const float*>(rq);
  a.rk = static_cast<const float*>(rk);
  a.rqk = reinterpret_cast<float*>(buf + sc.rqk);
  a.rv = static_cast<const float*>(rv);
  a.rvf = reinterpret_cast<uint4*>(buf + sc.rvf);
  a.L = L;
  a.Lp = Lp;
  a.H = heads;
  a.dv = dv;
  a.nkq = nkq;
  a.n[2] = Lp * Lp * 16;
  a.n[3] = Lp * ((dv + 15) / 16) * (Lp / 16) * 32;
  p.rqk = a.rqk;
  p.rvf = a.rvf;
  p.lsc = static_cast<const float*>(lsc);
  p.lbi = static_cast<const float*>(lbi);
  p.osc = static_cast<const float*>(osc);
  p.obi = static_cast<const float*>(obi);
  p.out = static_cast<bf16*>(out);
  p.b = b;
  p.L = L;
  p.heads = heads;
  p.plan = make_plan(Lp, heads, dv, p.seg, p.nseg);
  if (p.plan.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kM / Lp;
  const unsigned grid = static_cast<unsigned>((b + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_arrange(a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = Lp == 32 ? launch_dv<32>(p, dv, grid, st)
                 : launch_dv<64>(p, dv, grid, st);
  return static_cast<int>(err);
}
