// The Hopper (sm_90a) 3x3 SAME convolution body of the decode-node kernels'
// bf16 path: K4 (conv3x3.cu), K3 (scse_conv.cu) and both stages of K2
// (decode_pair.cu) run this one kernel, `conv3x3_sm90_kernel<GATE, UP0,
// CSUM>`, NCHW in and out.
//
//   out = bf16(relu?(scale * conv3x3(x) + bias))   x = cat(parts) [* gate]
//
// What bounds it: at 448 -> 64 channels at 512x512, 24 images, the product
// is 3.25 TFLOP against 6.4 GB of input and output, so the tensor cores'
// 3.3 ms is the floor; what the card must move between L2 and shared memory
// to feed them is the next limit. Measured on the H100 (K4, PERF.md section
// 6), the fill (copies and shifts) alone takes longer than the products
// alone, and the two overlap only in part: the fill sets the pace. The
// design:
//   - an implicit GEMM per block of 8 output rows x 64 pixels x 64 output
//     channels: two consumer warpgroups of 4 rows each multiply with wgmma
//     m64n64k16 (M = the 64 pixels of a row, N = 64 channels, K = 16 input
//     channels), and four producer warps feed them (with fewer, their work
//     on the landed lines is exposed: PERF.md, section 6);
//   - the input arrives by TMA into a ring of 2 stages of 16 input channels,
//     with full/empty mbarriers. A 4-D tensor map over NCHW with its
//     dimensions ordered (W, C, H, B) lands a box of (64 px, 16 channels,
//     10 rows) as [row][channel][64 px]: 128-byte lines, swizzled by the TMA,
//     which is wgmma's M-major A operand as it is. SAME padding is the TMA's
//     zero fill of coordinates outside the map (negative ones included).
//     Tap dy is a whole-row offset into the box. Tap dx needs the box at
//     x0 - 1 and x0 + 1 too, which the TMA cannot load (the card faults on a
//     box whose W coordinate is not a multiple of 8): the producer warps
//     build them from the box at x0 and the 8 pixels on either side (two
//     small boxes at x0 - 8 and x0 + 64), shifting each 128-byte line by one
//     pixel with 16-byte shared-memory loads and stores that the swizzle
//     keeps free of bank conflicts;
//   - the parts of a virtual channel concat each have their own pair of
//     tensor maps; a 16-channel chunk lies in one part (every part but the
//     last has a multiple of 16 channels), so a chunk is one box;
//   - the weights of a chunk (9 taps x 16 x 64, 18 KB) arrive by one bulk
//     copy, arranged and swizzled by the wrapper into wgmma's N-major B
//     operand (ops/scse_conv.py `sm90_weight_operand`);
//   - the epilogue applies scale, bias and ReLU to the fp32 sums in
//     registers, rounds once, stages the tile in shared memory (the ring,
//     which is free by then) and writes every channel's row of 64 px as
//     16-byte stores.
//
// The compile-time choices:
//   GATE: the scSE gate of K3 and of K2's first stage. While they shift, the
//     producer warps gate every landed line in place,
//       v <- bf16(v * bf16(gate_c[b, c] + gs[y, x]))
//     (the rounding points of decode_conv.cuh's PartsFiller), the edge
//     pixels too; gs is the fp32 sSE map of gate_map_kernel, loaded once per
//     block for the haloed 10 x 80 px region. One read and three writes per
//     line.
//   UP0: part 0 is the W-upsampled map at half height (K2's up_part0). Its
//     box and edges are 6 half rows, landed beside the stage; the producers
//     blend each output row from its two half rows as row_blend / blend do
//     (fp32 blend, one rounding; at rows 0 and H - 1 a select), zero the
//     rows outside the image, then gate and shift.
//   CSUM: K2's second stage also writes each channel's fp32 sum of its
//     outputs inside the image, after affine and ReLU and before rounding,
//     to partial[b][tile][c]: warp shuffles, then the warps in order through
//     shared memory, so the sums do not change from run to run;
//     csum_reduce_kernel (decode_pair.cu) adds the tiles in tile order.

#pragma once

#include <sm90.cuh>

#include "decode_conv.cuh"
#include "tensor_map.cuh"

// How a kernel with its own thread count is launched. A host-side emulation
// of the device code may define it otherwise.
#ifndef DCONV_LAUNCH_T
#define DCONV_LAUNCH_T(kernel, grid, threads, smem, stream, params) \
  kernel<<<grid, threads, smem, stream>>>(params)
#endif

namespace dconv {

namespace s90 {
constexpr int kRows = 4;                     // output rows per warpgroup
constexpr int kWG = 2;                       // consumer warpgroups
constexpr int kTH = kRows * kWG;             // output rows per block
constexpr int kPX = 64;                      // output pixels per row (M)
constexpr int kN = 64;                       // output channels per block (N)
constexpr int kKS = 16;                      // input channels per stage (K)
constexpr int kStages = 2;
constexpr int kPW = 4;                       // producer warps
constexpr int kThreads = 128 * kWG + 32 * kPW;
constexpr int kLine = 128;                   // bytes of 64 bf16 values
constexpr int kBoxRows = kTH + 2;             // rows one box loads
constexpr int kLines = kBoxRows * kKS;        // 128-byte lines of a box
constexpr int kRow = kKS * kLine;             // one row of a box: 2 KB
constexpr int kBox = kLines * kLine;          // one box: 20 KB
constexpr int kEdge = kLines * 16;            // 8 px of a box's lines: 2.5 KB
constexpr int kWOff = 3 * kBox + 2 * kEdge;   // where the weights start
constexpr int kWBytes = 9 * kKS * kLine;      // one chunk's weights: 18 KB
constexpr int kStageBase = kWOff + kWBytes;   // 83 KB
// UP0: output rows y0 - 1 .. y0 + kTH blend half rows y0/2 - 1 .. y0/2 + kTH/2
constexpr int kHalfRows = kTH / 2 + 2;
constexpr int kHalfBox = kHalfRows * kKS * kLine;   // 12 KB
constexpr int kHalfEdge = kHalfRows * kKS * 16;
constexpr int kHalfArea = kHalfBox + 2 * kHalfEdge;
constexpr int kGsW = kPX + 16;                // gate row: x0 - 8 .. x0 + 71
constexpr int kGsBytes = kBoxRows * kGsW * 4;
constexpr int kLdo = kPX + 8;                 // staged output row, in values
constexpr int kStaged = kWG * kRows * kN * kLdo * 2;
constexpr int kProducerBar = 4;               // named barrier of the producers
constexpr int kSmemLimit = 232448;            // bytes a block may use on sm_90
}  // namespace s90

// Shared-memory layout of one instantiation: the ring of stages, then the
// gate rows (GATE), then the barriers.
template <bool GATE, bool UP0, bool CSUM>
struct Sm90Conv {
  static constexpr int kStage = s90::kStageBase + (UP0 ? s90::kHalfArea : 0);
  static constexpr int kGs = s90::kStages * kStage;
  static constexpr int kBars = kGs + (GATE ? s90::kGsBytes : 0);
  static constexpr int kSmem = 1024 + kBars + 3 * s90::kStages * 8;
  static_assert(s90::kBox % 1024 == 0 && s90::kWOff % 1024 == 0 &&
                    kStage % 1024 == 0 && s90::kStageBase % 1024 == 0,
                "every swizzled operand and box starts on a 1024-byte atom");
  static_assert(kSmem <= s90::kSmemLimit, "fits a block's shared memory");
  static_assert(s90::kStaged + (CSUM ? 4 * s90::kWG * s90::kN * 4 : 0) <=
                    s90::kStages * kStage,
                "the staged output and the channel sums fit in the ring");
};

struct Sm90Maps {
  CUtensorMap box;   // (W, C_i, rows, B), box (64, kKS, rows of a box, 1), swizzled
  CUtensorMap edge;  // the same, box (8, kKS, rows of a box, 1), not swizzled
};

struct Sm90Params {
  Sm90Maps maps[kMaxParts];
  int off[kMaxParts + 1];  // channel offsets of the parts in the concat
  int nparts;
  const float* gate_c;     // (B, C), already sigmoided (GATE)
  const float* gmap;       // (B, H, W) spatial gate (GATE)
  const bf16* w;           // (npass, nchunk, 9, kKS, 64), sm90_weight_operand
  const float* scale;      // (cout,)
  const float* bias;       // (cout,)
  bf16* out;               // (B, cout, H, W)
  float* partial;          // (B, ntx * nty, cout) (CSUM)
  int B, H, W, C, cout, nchunk, ntx, nty, relu;
};

// ---- the producers' arithmetic on packed bf16 words (two pixels, the lower
// one in the low half) ----

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}
// Two values rounded to bf16 at once, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
// v * bf16(g): the product of two bf16 values is exact in fp32, so this is
// the compute type's product with its one rounding (decode_conv.cuh mul_t);
// gate2 takes both values of a word with one bf16x2 product
__device__ __forceinline__ uint32_t gate1(uint32_t v, float g) {
  return bf16_bits(lo_f(v) * __bfloat162float(__float2bfloat16(g)));
}
__device__ __forceinline__ uint32_t gate2(uint32_t v, float g0, float g1) {
  __nv_bfloat162 x, g = __floats2bfloat162_rn(g0, g1);
  memcpy(&x, &v, 4);
  const __nv_bfloat162 r = __hmul2(x, g);
  uint32_t u;
  memcpy(&u, &r, 4);
  return u;
}
__device__ __forceinline__ float blend_f(const RowBlend& r, float lo,
                                         float hi) {
  return r.pick > 0 ? hi : (r.pick < 0 ? lo : r.w_lo * lo + (1.f - r.w_lo) * hi);
}
// Both pixels of a word of row r.lo and of row r.hi, blended and rounded.
__device__ __forceinline__ uint32_t blend_word(const RowBlend& r, uint32_t a,
                                               uint32_t c) {
  return pack2(blend_f(r, lo_f(a), lo_f(c)), blend_f(r, hi_f(a), hi_f(c)));
}

// gs[r * kGsW + i] = gmap[b, y0 - 1 + r, x0 - 8 + i], 0 outside the image.
__device__ __forceinline__ void load_gate_rows(const float* __restrict__ gmap,
                                               int b, int y0, int x0, int H,
                                               int W, float* gs, int lane) {
  using namespace s90;
  for (int e = lane; e < kBoxRows * kGsW; e += 32 * kPW) {
    const int y = y0 - 1 + e / kGsW, x = x0 - 8 + e % kGsW;
    gs[e] = (y >= 0 && y < H && x >= 0 && x < W)
                ? gmap[(static_cast<size_t>(b) * H + y) * W + x]
                : 0.f;
  }
}

// The three boxes of one stage st, [dx][row][channel][64 px] from st: the
// dx = 1 box and the dx = 0 / dx = 2 boxes shifted one pixel right / left
// from it (pixel 0 of dx = 0 is element 7 of the left edge's line, pixel 63
// of dx = 2 element 0 of the right edge's line). The boxes are 128-byte
// swizzled (16-byte piece j of line l at piece j ^ (l % 8)), so lanes on 8
// consecutive lines touch distinct banks; the edges are plain 16-byte lines.
//   HALF: the dx = 1 lines are first blended from part 0's half rows (half:
//     the half box, then its left and right edges), and zero outside the
//     image; their lines have the same swizzle (l % 8 is the channel's).
//   GATE: every value is gated (gc: the chunk's channel gates, gs: the
//     block's gate rows) and the dx = 1 line is written back.
template <bool GATE, bool HALF>
__device__ __forceinline__ void build_boxes(unsigned char* st,
                                            const unsigned char* half,
                                            const float* gs, const float* gc,
                                            int cvalid, int y0, int H,
                                            int lane) {
  using namespace s90;
  unsigned char* c = st + kBox;
  for (int l = lane; l < kLines; l += 32 * kPW) {
    const int sw = l % 8, r = l / kKS, kk = l % kKS;
    uint32_t w[32], lo, hi;
    if constexpr (HALF) {
      const int y = y0 - 1 + r;
      lo = hi = 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) w[i] = 0u;
      if (y >= 0 && y < H) {
        const RowBlend rb = row_blend(y, H);
        const int la = (rb.lo - (y0 / 2 - 1)) * kKS + kk;
        const int lc = (rb.hi - (y0 / 2 - 1)) * kKS + kk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 a =
              *reinterpret_cast<const uint4*>(half + la * kLine + 16 * (j ^ sw));
          const uint4 b =
              *reinterpret_cast<const uint4*>(half + lc * kLine + 16 * (j ^ sw));
          w[4 * j] = blend_word(rb, a.x, b.x);
          w[4 * j + 1] = blend_word(rb, a.y, b.y);
          w[4 * j + 2] = blend_word(rb, a.z, b.z);
          w[4 * j + 3] = blend_word(rb, a.w, b.w);
        }
        const unsigned char* el = half + kHalfBox;
        const unsigned char* er = el + kHalfEdge;
        lo = blend_word(rb, *reinterpret_cast<const uint16_t*>(el + la * 16 + 14),
                        *reinterpret_cast<const uint16_t*>(el + lc * 16 + 14)) &
             0xFFFFu;
        hi = blend_word(rb, *reinterpret_cast<const uint16_t*>(er + la * 16),
                        *reinterpret_cast<const uint16_t*>(er + lc * 16)) &
             0xFFFFu;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(c + l * kLine + 16 * (j ^ sw));
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
      lo = *reinterpret_cast<const uint16_t*>(st + 3 * kBox + l * 16 + 14);
      hi = *reinterpret_cast<const uint16_t*>(st + 3 * kBox + kEdge + l * 16);
    }
    if constexpr (GATE) {
      const float g = kk < cvalid ? gc[kk] : 0.f;
      const float* gr = gs + r * kGsW + 8;   // pixel x0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 s2 = reinterpret_cast<const float2*>(gr)[i];
        w[i] = gate2(w[i], g + s2.x, g + s2.y);
      }
      lo = gate1(lo, g + gr[-1]);
      hi = gate1(hi, g + gr[kPX]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t r0[4], r2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        r0[q] = (w[i] << 16) | (i == 0 ? lo : w[i - 1] >> 16);
        r2[q] = (w[i] >> 16) | ((i == 31 ? hi : w[i + 1] & 0xFFFFu) << 16);
      }
      const int o = l * kLine + 16 * (j ^ sw);
      if constexpr (GATE || HALF)
        *reinterpret_cast<uint4*>(c + o) =
            make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
      *reinterpret_cast<uint4*>(st + o) = make_uint4(r0[0], r0[1], r0[2], r0[3]);
      *reinterpret_cast<uint4*>(st + 2 * kBox + o) =
          make_uint4(r2[0], r2[1], r2[2], r2[3]);
    }
  }
}

template <bool GATE, bool UP0, bool CSUM>
__global__ void __launch_bounds__(s90::kThreads, 1)
    conv3x3_sm90_kernel(const __grid_constant__ Sm90Params p) {
  using namespace s90;
  using K = Sm90Conv<GATE, UP0, CSUM>;
  extern __shared__ __align__(128) unsigned char smem[];
  // the swizzle is a function of the address: operands start 1024-aligned
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  float* gs = reinterpret_cast<float*>(ring + K::kGs);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;  // the boxes of a stage

  int bid = blockIdx.x;
  const int x0 = (bid % p.ntx) * kPX;
  bid /= p.ntx;
  const int y0 = (bid % p.nty) * kTH;
  bid /= p.nty;
  const int b = bid % p.B;
  const int pass = bid / p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + kPW);  // the weights' and the shifters'
      sm90::mbar_init(&empty[s], kWG);
      sm90::mbar_init(&landed[s], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 4 * kWG) {
    // producers: thread 0 of the first producer warp starts every copy. The
    // card faults on a TMA box whose first W coordinate is not a multiple of
    // 8 (16 bytes), so only the dx = 1 box comes by TMA at x0; the producer
    // warps build the other two from it and from the 8 pixels on either
    // side (boxes at x0 - 8 and x0 + 64). Coordinates outside the map, the
    // negative ones included, read zeros: that is the SAME padding.
    const int lane = threadIdx.x - 128 * kWG;
    if constexpr (GATE) {
      load_gate_rows(p.gmap, b, y0, x0, p.H, p.W, gs, lane);
      sm90::bar_sync(kProducerBar, 32 * kPW);
    }
    const bf16* wsrc =
        p.w + static_cast<size_t>(pass) * p.nchunk * (kWBytes / 2);
    for (int kc = 0; kc < p.nchunk; ++kc) {
      const int s = kc % kStages;
      const uint32_t parity = (kc / kStages) & 1;
      // the part that holds the chunk
      int part = 0;
      while (part + 1 < p.nparts && kc * kKS >= p.off[part + 1]) ++part;
      const int cl = kc * kKS - p.off[part];
      const bool half = UP0 && part == 0;
      sm90::mbar_wait(&empty[s], parity ^ 1);
      unsigned char* st = ring + s * K::kStage;
      unsigned char* hs = st + kStageBase;  // UP0: part 0's half rows
      if (lane == 0) {
        const Sm90Maps& m = p.maps[part];
        if (half) {
          const int hy = y0 / 2 - 1;
          sm90::mbar_arrive_expect_tx(&landed[s], kHalfBox + 2 * kHalfEdge);
          sm90::tma_load_4d(hs, &m.box, &landed[s], x0, cl, hy, b);
          sm90::tma_load_4d(hs + kHalfBox, &m.edge, &landed[s], x0 - 8, cl, hy,
                            b);
          sm90::tma_load_4d(hs + kHalfBox + kHalfEdge, &m.edge, &landed[s],
                            x0 + kPX, cl, hy, b);
        } else {
          sm90::mbar_arrive_expect_tx(&landed[s], kBox + 2 * kEdge);
          sm90::tma_load_4d(st + kBox, &m.box, &landed[s], x0, cl, y0 - 1, b);
          sm90::tma_load_4d(st + 3 * kBox, &m.edge, &landed[s], x0 - 8, cl,
                            y0 - 1, b);
          sm90::tma_load_4d(st + 3 * kBox + kEdge, &m.edge, &landed[s],
                            x0 + kPX, cl, y0 - 1, b);
        }
        sm90::mbar_arrive_expect_tx(&full[s], kWBytes);
        sm90::bulk_load(st + kWOff,
                        wsrc + static_cast<size_t>(kc) * (kWBytes / 2),
                        kWBytes, &full[s]);
      }
      sm90::mbar_wait(&landed[s], parity);
      const float* gc =
          GATE ? p.gate_c + static_cast<size_t>(b) * p.C + kc * kKS : nullptr;
      const int cvalid = p.C - kc * kKS;
      if (half)
        build_boxes<GATE, UP0>(st, hs, gs, gc, cvalid, y0, p.H, lane);
      else
        build_boxes<GATE, false>(st, hs, gs, gc, cvalid, y0, p.H, lane);
      sm90::fence_proxy_async();  // the built boxes are seen by wgmma
      __syncwarp();
      if (lane % 32 == 0) sm90::mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns output rows y0 + 4 wg .. y0 + 4 wg + 3
  const int wg = warp / 4;
  float acc[kRows][32];  // set by the first product (accumulate = 0)

  // K rows of both operands are 128-byte lines; groups of 8 are 1024 bytes
  // apart. With one swizzle atom along M and along N, the leading byte
  // offset is never used; it is given the same value.
  constexpr uint32_t kSBO = 8 * kLine;
  for (int kc = 0; kc < p.nchunk; ++kc) {
    const int s = kc % kStages;
    sm90::mbar_wait(&full[s], (kc / kStages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
    const unsigned char* st = ring + s * K::kStage;
    sm90::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db =
          sm90::desc_sw128(st + kWOff + tap * kRow, kSBO, kSBO);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint64_t da = sm90::desc_sw128(
            st + dx * kBox + (wg * kRows + r + dy) * kRow, kSBO, kSBO);
        sm90::wgmma_m64n64k16_bf16<1, 1>(acc[r], da, db, kc > 0 || tap > 0);
      }
    }
    sm90::wgmma_commit();
    // the previous chunk's products are done: release its stage
    sm90::wgmma_wait<1>();
    if (kc > 0 && threadIdx.x % 128 == 0)
      sm90::mbar_arrive(&empty[(kc - 1) % kStages]);
  }
  sm90::wgmma_wait<0>();

  // epilogue: both warpgroups are done with the ring, which now holds the
  // rounded outputs as [row][channel][kLdo] (and, CSUM, the warps' sums)
  sm90::bar_sync(1, 128 * kWG);
  const int t = threadIdx.x % 128, lane = t % 32, wl = t / 32;
  bf16* stg = reinterpret_cast<bf16*>(ring) + wg * kRows * kN * kLdo;
  const int n0 = pass * kN;
  float cs[16];  // CSUM: this thread's sums of channel 8 (j / 2) + 2 (lane % 4) + j % 2
#pragma unroll
  for (int j = 0; j < 16; ++j) cs[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int m = 16 * wl + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const bool live = n0 + n < p.cout;
    const float sc = live ? p.scale[n0 + n] : 0.f;
    const float bi = live ? p.bias[n0 + n] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = acc[r][i] * sc + bi;
      if (p.relu) v = fmaxf(v, 0.f);
      stg[(r * kN + n) * kLdo + m] = __float2bfloat16(v);
      if constexpr (CSUM) {
        if (x0 + m < p.W && y0 + wg * kRows + r < p.H)
          cs[2 * (i >> 2) + (i & 1)] += v;
      }
    }
  }
  if constexpr (CSUM) {
    // lanes with the same lane % 4 hold the same channels
#pragma unroll
    for (int j = 0; j < 16; ++j)
      for (int o = 4; o < 32; o <<= 1)
        cs[j] += __shfl_xor_sync(0xFFFFFFFFu, cs[j], o);
    float* red = reinterpret_cast<float*>(ring + kStaged);  // [warp][kN]
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        red[warp * kN + 8 * (j >> 1) + 2 * lane + (j & 1)] = cs[j];
    }
    sm90::bar_sync(1, 128 * kWG);
    if (threadIdx.x < kN && n0 + static_cast<int>(threadIdx.x) < p.cout) {
      float s = 0.f;
      for (int w8 = 0; w8 < 4 * kWG; ++w8) s += red[w8 * kN + threadIdx.x];
      const int tile = (y0 / kTH) * p.ntx + x0 / kPX;
      p.partial[(static_cast<size_t>(b) * p.ntx * p.nty + tile) * p.cout + n0 +
                threadIdx.x] = s;
    }
  } else {
    sm90::bar_sync(2 + wg, 128);
  }
  for (int e = t; e < kRows * kN * (kPX / 8); e += 128) {
    const int j = e % (kPX / 8), n = (e / (kPX / 8)) % kN,
              r = e / (kN * (kPX / 8));
    const int y = y0 + wg * kRows + r, x = x0 + 8 * j;
    if (y < p.H && x < p.W && n0 + n < p.cout) {
      *reinterpret_cast<uint4*>(
          p.out + ((static_cast<size_t>(b) * p.cout + n0 + n) * p.H + y) * p.W +
          x) = *reinterpret_cast<const uint4*>(stg + (r * kN + n) * kLdo + 8 * j);
    }
  }
}

// The two maps of an NCHW bf16 map (B, C, rows, W), read by boxes of
// box_rows rows.
inline bool encode_maps(Sm90Maps& m, const void* x, int B, int C, int rows,
                        int W, int box_rows) {
  using namespace s90;
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t plane = static_cast<cuuint64_t>(rows) * W * 2;
  const cuuint64_t strides[3] = {plane, static_cast<cuuint64_t>(W) * 2,
                                 plane * C};
  const cuuint32_t box[4] = {kPX, kKS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t edge[4] = {8, kKS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(&m.box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&m.edge, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, edge, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the sm90 body.
struct Sm90Args {
  Parts parts;           // the concat; parts.up0: part 0 at half height
  const float* gate_c;   // (B, C), already sigmoided (GATE)
  const float* gmap;     // (B, H, W) from gate_map_kernel (GATE)
  const void* w;         // sm90_weight_operand: (coutP / 64, ceil(C / 16), 9, 16, 64)
  const float* scale;    // (cout,)
  const float* bias;     // (cout,)
  void* out;             // (B, cout, H, W)
  float* partial;        // (B, sm90_tiles(H, W), cout) (CSUM)
  int B, H, W, cout, coutP, relu;
};

// Output tiles of an (H, W) map, the second dimension of `partial`.
inline int sm90_tiles(int H, int W) {
  return ((W + s90::kPX - 1) / s90::kPX) * ((H + s90::kTH - 1) / s90::kTH);
}

// Checks what the TMA, the bulk copy and the 16-byte stores need (W % 8 ==
// 0; 16-byte-aligned parts, weights and output; every part but the last a
// multiple of 16 channels, so that a chunk never straddles two parts; under
// up0 an even H), encodes the maps and launches. cudaErrorInvalidValue for
// what the body does not take.
template <bool GATE, bool UP0, bool CSUM>
cudaError_t launch_conv_sm90(const Sm90Args& a, cudaStream_t stream) {
  using namespace s90;
  using K = Sm90Conv<GATE, UP0, CSUM>;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const Parts& ps = a.parts;
  bool ok = a.W % 8 == 0 && aligned(a.w) && aligned(a.out) &&
            a.coutP % kN == 0 && ps.n >= 1 && ps.n <= kMaxParts &&
            (ps.up0 != 0) == UP0 && (!UP0 || a.H % 2 == 0) &&
            (!GATE || (a.gate_c != nullptr && a.gmap != nullptr)) &&
            (!CSUM || a.partial != nullptr);
  Sm90Params p;
  for (int i = 0; ok && i < ps.n; ++i) {
    const bool h = UP0 && i == 0;
    ok = aligned(ps.ptr[i]) && (i == ps.n - 1 || ps.ch[i] % kKS == 0) &&
         encode_maps(p.maps[i], ps.ptr[i], a.B, ps.ch[i], h ? a.H / 2 : a.H,
                     a.W, h ? kHalfRows : kBoxRows);
  }
  if (!ok) return cudaErrorInvalidValue;
  for (int i = 0; i <= kMaxParts; ++i) p.off[i] = ps.off[i];
  p.nparts = ps.n;
  p.gate_c = a.gate_c;
  p.gmap = a.gmap;
  p.w = static_cast<const bf16*>(a.w);
  p.scale = a.scale;
  p.bias = a.bias;
  p.out = static_cast<bf16*>(a.out);
  p.partial = a.partial;
  p.B = a.B;
  p.H = a.H;
  p.W = a.W;
  p.C = ps.off[ps.n];
  p.cout = a.cout;
  p.nchunk = (p.C + kKS - 1) / kKS;
  p.ntx = (a.W + kPX - 1) / kPX;
  p.nty = (a.H + kTH - 1) / kTH;
  p.relu = a.relu;
  const long long grid =
      static_cast<long long>(a.coutP / kN) * a.B * p.nty * p.ntx;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  void (*kernel)(const Sm90Params) = conv3x3_sm90_kernel<GATE, UP0, CSUM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  DCONV_LAUNCH_T(kernel, static_cast<unsigned>(grid), s90::kThreads, K::kSmem,
                 stream, p);
  return cudaGetLastError();
}

}  // namespace dconv
