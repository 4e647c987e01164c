// Device code shared by the decode-node convolution kernels for Hopper
// (sm_90a): conv3x3.cu (K4), scse_conv.cu (K3) and decode_pair.cu (K2).
//
// All three compute a 3x3 SAME convolution as an implicit GEMM over NCHW
// maps, with fp32 accumulation, a per-channel affine (folded eval BatchNorm)
// and an optional ReLU. One thread block owns a TH x 32 tile of output
// pixels of one image and every output channel. The convolution's input
// (the virtual concat of the parts, optionally scSE-gated, or the first
// stage's output) is brought to shared memory channels-last, a chunk of 32
// channels at a time, as a tile that carries its halo ring. Its pixels are
// numbered row by row over the haloed width PW, so tap (dy, dx) of output
// position q reads position q + (dy-1)*PW + (dx-1): the A operand of every
// tap is the same tile at another row offset, and 16 consecutive positions
// are one 16-row matrix tile whatever the width. Positions that fall in the
// halo columns are computed and thrown away (2/PW of the work).
//
// bf16 runs on the tensor cores (wmma 16x16x16, fp32 accumulators: each of
// the 8 warps holds 2 position tiles x 4 channel tiles); fp32 runs on the
// FMA units (one position per thread, 64 channel accumulators), because the
// tensor cores would round fp32 operands to TF32. Both leave their sums in
// shared memory as Cs[channel][position] for a common epilogue that writes
// NCHW rows.
//
// What bounds these kernels on this card: at the main-path shapes (448 -> 64
// channels at 512x512, 24 images) the product is 3.25 TFLOP against 6.4 GB
// of input and output, so the floor is the tensor cores' 3.3 ms, with the
// memory's 1.9 ms close behind. These kernels are far from either: the
// tile is filled with scalar loads through a transpose whose shared-memory
// stores conflict 8 ways, the products are wmma and not wgmma, and the
// gate's logit costs a second read of the parts (gate_map_kernel).
// What they do about latency: a thread starts its global loads in batches
// (eight tile values, nine 16-byte weight pieces) before the batch's first
// store, and two blocks of a one-stage bf16 kernel share an SM, so one fills
// while the other multiplies (the pair kernel's 128 KB leave room for one).
// Holding a whole chunk's loads in registers across the products was tried
// and lost: 255 registers with spills and one block per SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

// How a kernel is launched: kThreads threads a block on the given stream. A
// host-side emulation of the device code may define it otherwise.
#ifndef DCONV_LAUNCH
#define DCONV_LAUNCH(kernel, grid, smem, stream, params) \
  kernel<<<grid, dconv::kThreads, smem, stream>>>(params)
#endif

namespace dconv {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;                  // input channels per staged chunk
constexpr int kNC = 64;                  // output channels per pass
constexpr int kMT = 2;                   // 16-position tiles per warp
constexpr int kM = kWarps * kMT * 16;    // positions per block (= kThreads)
constexpr int kLdc = kM + 4;             // row stride of Cs
constexpr int kTW = 32;                  // output tile width
constexpr int kMaxParts = 8;

static_assert(kM == kThreads, "the fp32 path maps one position to a thread");

// Blocks of a one-stage kernel that should share an SM: two in bf16 (73 KB of
// shared memory each; the bound keeps them at 128 registers a thread), one
// in fp32 (119 KB).
template <typename T>
constexpr int kBlocksPerSM = sizeof(T) == 2 ? 2 : 1;

// Row strides in shared memory. bf16 rows are multiples of 32 bytes, as
// wmma's loads need; fp32 rows are odd, so neighbouring positions fall on
// distinct banks.
template <typename T>
struct Ld;
template <>
struct Ld<bf16> {
  static constexpr int pad = 16;
  static constexpr int ldw = kNC + 8;
};
template <>
struct Ld<float> {
  static constexpr int pad = 1;
  static constexpr int ldw = kNC;
};

// Geometry of a block's haloed tile: TH x kTW outputs, HALO rings.
template <int TH_, int HALO_>
struct Geo {
  static constexpr int TH = TH_;
  static constexpr int HALO = HALO_;
  static constexpr int PW = kTW + 2 * HALO;
  static constexpr int PH = TH + 2 * HALO;
  static constexpr int npix = PW * PH;
  // rows of a channels-last tile: the kM positions of the widest stage plus
  // the reach of the taps on both sides
  static constexpr int rows = kM + 2 * (PW + 1);
  static_assert(rows >= npix, "tile rows must cover the haloed tile");
};

// What a block knows of the kKC channels of the chunk it is filling: where
// each channel's plane of this image starts (null beyond the last channel)
// and its channel gate.
struct ChunkTable {
  const void* plane[kKC];
  float gate_c[kKC];
};

constexpr size_t up128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Byte offsets of a block's shared-memory regions. Cs overlays the staged
// tile and weights, which are dead when the sums are stored.
template <typename T, typename G>
struct Smem {
  static constexpr int lda = kKC + Ld<T>::pad;   // staged chunk tile
  static constexpr int ld1 = kNC + Ld<T>::pad;   // resident first-stage tile
  static constexpr size_t gs = 0;                // fp32 gate per tile pixel
  static constexpr size_t tab = up128(G::npix * sizeof(float));  // ChunkTable
  static constexpr size_t tile = tab + up128(sizeof(ChunkTable));
  static constexpr size_t ws = tile + up128(G::rows * lda * sizeof(T));
  static constexpr size_t one =
      cmax(ws + up128(9 * kKC * Ld<T>::ldw * sizeof(T)),
           tile + up128(kNC * kLdc * sizeof(float)));
  static constexpr size_t y1 = one;
  static constexpr size_t pair = one + up128(G::rows * ld1 * sizeof(T));
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Product in the compute type (one rounding).
__device__ __forceinline__ float mul_t(float a, float b) { return a * b; }
__device__ __forceinline__ bf16 mul_t(bf16 a, bf16 b) { return __hmul(a, b); }

// The parts of a virtual channel concat, NCHW. With up0, part 0 is
// (B, ch[0], H/2, W): upsampled along W only, the H direction of the
// bilinear x2 is taken by the kernels (row_blend).
struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
  int off[kMaxParts + 1];  // channel offsets in the concat; off[n] = C
  int n;
  int up0;
};

// The H direction of part 0's bilinear x2 under up0, at output row y of H:
// rows r.lo and r.hi of the half-height map with weights r.w_lo and
// 1 - r.w_lo (half-pixel centres: even rows .25/.75 of half rows m-1, m; odd
// rows .75/.25 of m, m+1). At rows 0 and H-1 the clamp is a select (r.pick:
// -1 takes the low row, +1 the high row, 0 interpolates), not a blend.
struct RowBlend {
  int lo, hi, pick;
  float w_lo;
};
__device__ __forceinline__ RowBlend row_blend(int y, int H) {
  const int Hh = H >> 1;
  const int r0 = (y & 1) ? (y >> 1) : (y >> 1) - 1;
  RowBlend r;
  r.lo = r0 < 0 ? 0 : r0;
  r.hi = r0 + 1 > Hh - 1 ? Hh - 1 : r0 + 1;
  r.pick = y == 0 ? 1 : (y == H - 1 ? -1 : 0);
  r.w_lo = (y & 1) ? 0.75f : 0.25f;
  return r;
}
// The interpolated value of two values of T given as fp32: blended in fp32,
// then rounded to T.
template <typename T>
__device__ __forceinline__ T blend(const RowBlend& r, float lo, float hi) {
  if (r.pick > 0) return from_f<T>(hi);
  if (r.pick < 0) return from_f<T>(lo);
  return from_f<T>(r.w_lo * lo + (1.f - r.w_lo) * hi);
}

// VEC consecutive values of T as fp32; VEC > 1 is one 16-byte load (4 fp32
// values, or 8 bf16 values unpacked from their 4 words, low half first).
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4&, float (&)[1]) {}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* ptr, float (&v)[VEC]) {
  if (VEC == 1) {
    v[0] = to_f(ptr[0]);
  } else {
    static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte vectors");
    unpack(*reinterpret_cast<const uint4*>(ptr), v);
  }
}

// The spatial gate of the whole map, ahead of the convolution:
//   gmap[b, y, x] = sigmoid(sum_c fp32(x_c) * wsse[c] + bsse)
// over the virtual concat, from the values the product multiplies (under up0
// the interpolated, rounded rows of part 0). The logit needs every channel
// of a pixel before its first product, and a haloed tile of all channels
// does not fit in shared memory, so the parts are read once here, at the
// memory's pace (a thread takes VEC pixels of a row with 16-byte loads), and
// once more by the convolution.
struct GateMapParams {
  Parts parts;
  const float* wsse;  // (C,)
  const float* bsse;  // (1,)
  float* gmap;        // (B, H, W)
  int B, H, W;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    gate_map_kernel(const GateMapParams p) {
  const int H = p.H, W = p.W, wg = W / VEC;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(p.B) * H * wg) return;
  const int x = static_cast<int>(idx % wg) * VEC;
  const int y = static_cast<int>((idx / wg) % H);
  const int b = static_cast<int>(idx / (static_cast<long long>(wg) * H));
  float t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) t[i] = 0.f;
  for (int part = 0; part < p.parts.n; ++part) {
    const T* base = static_cast<const T*>(p.parts.ptr[part]);
    const float* w = p.wsse + p.parts.off[part];
    const int ch = p.parts.ch[part];
    if (part == 0 && p.parts.up0) {
      const RowBlend r = row_blend(y, H);
      const size_t plane = static_cast<size_t>(H >> 1) * W;
      const T* src = base + static_cast<size_t>(b) * ch * plane + x;
#pragma unroll 4
      for (int c = 0; c < ch; ++c) {
        float lo[VEC], hi[VEC];
        load_vec<T, VEC>(src + c * plane + static_cast<size_t>(r.lo) * W, lo);
        load_vec<T, VEC>(src + c * plane + static_cast<size_t>(r.hi) * W, hi);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          t[i] = fmaf(to_f(blend<T>(r, lo[i], hi[i])), w[c], t[i]);
      }
    } else {
      const size_t plane = static_cast<size_t>(H) * W;
      const T* src = base + static_cast<size_t>(b) * ch * plane +
                     static_cast<size_t>(y) * W + x;
#pragma unroll 4
      for (int c = 0; c < ch; ++c) {
        float v[VEC];
        load_vec<T, VEC>(src + c * plane, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) t[i] = fmaf(v[i], w[c], t[i]);
      }
    }
  }
  const float bsse = p.bsse[0];
  float* dst = p.gmap + (static_cast<size_t>(b) * H + y) * W + x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = 1.f / (1.f + expf(-(t[i] + bsse)));
}

// Launches gate_map_kernel: 16-byte loads when the rows allow them.
template <typename T>
cudaError_t launch_gate_map(const GateMapParams& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  bool vec = p.W % V == 0;
  for (int i = 0; i < p.parts.n; ++i)
    vec = vec && reinterpret_cast<size_t>(p.parts.ptr[i]) % 16 == 0;
  const long long threads =
      static_cast<long long>(p.B) * p.H * (vec ? p.W / V : p.W);
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  void (*kernel)(const GateMapParams) =
      vec ? gate_map_kernel<T, V> : gate_map_kernel<T, 1>;
  DCONV_LAUNCH(kernel, static_cast<unsigned>(grid), 0, stream, p);
  return cudaGetLastError();
}

// gs[pix] = gmap[b, y, x] for the pixels of the haloed tile whose origin is
// (y0 - HALO, x0 - HALO); 0 outside the image.
template <typename G>
__device__ void load_gates(const float* __restrict__ gmap, int b, int y0,
                           int x0, int H, int W, float* gs) {
  for (int pix = threadIdx.x; pix < G::npix; pix += kThreads) {
    const int y = y0 - G::HALO + pix / G::PW;
    const int x = x0 - G::HALO + pix % G::PW;
    gs[pix] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? gmap[(static_cast<size_t>(b) * H + y) * W + x]
                  : 0.f;
  }
}

// Brings the channels [k0, k0 + kKC) of the virtual concat for the haloed
// tile to shared memory, gated in the compute type, channels-last as
// tile[pix * lda + kk]; zero outside the image (SAME padding) and beyond the
// last channel. `prepare` has 32 threads look up each channel's part once
// (ChunkTable); after a barrier `fill` has every thread take its elements in
// batches of kBatch: all of a batch's global loads are started before its
// first store, so a batch costs one memory latency and not kBatch of them.
// With UP0 the two half-height rows under a pixel of part 0 are loaded and
// interpolated (row_blend).
constexpr int kBatch = 8;

template <typename T, typename G, bool UP0>
struct PartsFiller {
  static constexpr int NL = (kKC * G::npix + kThreads - 1) / kThreads;
  const Parts& ps;
  int b, y0, x0, H, W, C;
  bool gated;
  const float* gate_c;
  const float* gs;
  ChunkTable* tab;
  T* tile;
  int lda;

  __device__ __forceinline__ void prepare(int k0) const {
    const int kk = threadIdx.x;
    if (kk >= kKC) return;
    const int cg = k0 + kk;
    const void* plane = nullptr;
    float gc = 0.f;
    if (cg < C) {
      int p = 0;
      while (p + 1 < ps.n && cg >= ps.off[p + 1]) ++p;
      const int rows = (UP0 && p == 0) ? (H >> 1) : H;
      plane = static_cast<const T*>(ps.ptr[p]) +
              (static_cast<size_t>(b) * ps.ch[p] + (cg - ps.off[p])) * rows * W;
      if (gated) gc = gate_c[static_cast<size_t>(b) * C + cg];
    }
    tab->plane[kk] = plane;
    tab->gate_c[kk] = gc;
  }

  __device__ __forceinline__ void fill(int k0) const {
    const int up_channels = UP0 ? ps.ch[0] - k0 : 0;  // kk below: part 0
#pragma unroll 1
    for (int j0 = 0; j0 < NL; j0 += kBatch) {
      T lo[kBatch], hi[UP0 ? kBatch : 1];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = threadIdx.x + (j0 + u) * kThreads;
        const int kk = e / G::npix, pix = e % G::npix;
        const int y = y0 - G::HALO + pix / G::PW;
        const int x = x0 - G::HALO + pix % G::PW;
        lo[u] = from_f<T>(0.f);
        if (UP0) hi[u] = from_f<T>(0.f);
        if (e < kKC * G::npix && y >= 0 && y < H && x >= 0 && x < W) {
          const T* plane = static_cast<const T*>(tab->plane[kk]);
          if (plane != nullptr) {
            if (UP0 && kk < up_channels) {
              const RowBlend r = row_blend(y, H);
              lo[u] = plane[static_cast<size_t>(r.lo) * W + x];
              hi[u] = plane[static_cast<size_t>(r.hi) * W + x];
            } else {
              lo[u] = plane[static_cast<size_t>(y) * W + x];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = threadIdx.x + (j0 + u) * kThreads;
        if (e < kKC * G::npix) {
          const int kk = e / G::npix, pix = e % G::npix;
          T v = lo[u];
          if (UP0 && kk < up_channels) {
            const int y = y0 - G::HALO + pix / G::PW;
            if (y >= 0 && y < H)
              v = blend<T>(row_blend(y, H), to_f(v), to_f(hi[u]));
          }
          if (gated) v = mul_t(v, from_f<T>(tab->gate_c[kk] + gs[pix]));
          tile[pix * lda + kk] = v;
        }
      }
    }
  }
};

// The filler of a stage whose input tile is already resident.
struct NoFiller {
  __device__ __forceinline__ void prepare(int) const {}
  __device__ __forceinline__ void fill(int) const {}
};

// Rows [k0, k0 + kKC) x columns [n0, n0 + kNC) of each tap's (K, coutP)
// weight matrix into Ws[(tap * kKC + kk) * ldw + n], in 16-byte pieces, nine
// loads in flight per thread; zero beyond K and coutP. coutP is a multiple
// of 16.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ wts, int K,
                                              int coutP, int k0, int n0,
                                              T* Ws) {
  constexpr int V = 16 / sizeof(T);
  constexpr int ldw = Ld<T>::ldw;
  constexpr int NW = 9 * kKC * (kNC / V) / kThreads;
  static_assert(NW % 9 == 0, "weight pieces per thread come in nines");
  for (int j0 = 0; j0 < NW; j0 += 9) {
    uint4 v[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int e = threadIdx.x + (j0 + j) * kThreads;
      const int n = (e % (kNC / V)) * V;
      const int r = e / (kNC / V);
      const int kk = r % kKC, tap = r / kKC;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < K && n0 + n < coutP) {
        v[j] = *reinterpret_cast<const uint4*>(
            wts + (static_cast<size_t>(tap) * K + k0 + kk) * coutP + n0 + n);
      }
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int e = threadIdx.x + (j0 + j) * kThreads;
      const int n = (e % (kNC / V)) * V;
      const int r = e / (kNC / V);
      *reinterpret_cast<uint4*>(Ws + r * ldw + n) = v[j];
    }
  }
}

// A block's accumulators.
template <typename T>
struct Acc;
template <>
struct Acc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      c[kMT][kNC / 16];
};
template <>
struct Acc<float> {
  float v[kNC];
};

__device__ __forceinline__ void acc_zero(Acc<bf16>& acc) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNC / 16; ++j)
      nvcuda::wmma::fill_fragment(acc.c[i][j], 0.f);
}
__device__ __forceinline__ void acc_zero(Acc<float>& acc) {
#pragma unroll
  for (int n = 0; n < kNC; ++n) acc.v[n] = 0.f;
}

// One chunk of depth kc: acc[m][n] += sum_tap sum_kk A[q_begin + m +
// shift(tap)][kk] * Ws[tap][kk][n], for nmt position tiles and nt channel
// tiles (bf16: kc is rounded up to 16; the rows and columns beyond are
// zero in both operands).
template <int PW>
__device__ __forceinline__ void mma_chunk(const bf16* A, int lda,
                                          const bf16* Ws, int kc, int q_begin,
                                          int nmt, int nt, Acc<bf16>& acc) {
  using namespace nvcuda;
  constexpr int ldw = Ld<bf16>::ldw;
  const int warp = threadIdx.x / 32;
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3 - 1) * PW + (tap % 3 - 1);
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfrag[kNC / 16];
#pragma unroll
      for (int j = 0; j < kNC / 16; ++j) {
        if (j < nt)
          wmma::load_matrix_sync(bfrag[j], Ws + (tap * kKC + kk) * ldw + j * 16,
                                 ldw);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int mt = warp * kMT + i;
        if (mt < nmt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              afrag;
          wmma::load_matrix_sync(
              afrag, A + (q_begin + mt * 16 + shift) * lda + kk, lda);
#pragma unroll
          for (int j = 0; j < kNC / 16; ++j) {
            if (j < nt) wmma::mma_sync(acc.c[i][j], afrag, bfrag[j], acc.c[i][j]);
          }
        }
      }
    }
  }
}

template <int PW>
__device__ __forceinline__ void mma_chunk(const float* A, int lda,
                                          const float* Ws, int kc, int q_begin,
                                          int nmt, int /*nt*/,
                                          Acc<float>& acc) {
  constexpr int ldw = Ld<float>::ldw;
  // positions beyond the stage's tiles would read past the tile's rows
  if (static_cast<int>(threadIdx.x) >= nmt * 16) return;
  const int q = q_begin + threadIdx.x;
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3 - 1) * PW + (tap % 3 - 1);
    const float* a = A + (q + shift) * lda;
    const float* w = Ws + tap * kKC * ldw;
    for (int kk = 0; kk < kc; ++kk) {
      const float x = a[kk];
#pragma unroll
      for (int n = 0; n < kNC; ++n)
        acc.v[n] = fmaf(x, w[kk * ldw + n], acc.v[n]);
    }
  }
}

__device__ __forceinline__ void acc_store(const Acc<bf16>& acc, int nmt,
                                          int nt, float* Cs) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int mt = warp * kMT + i;
    if (mt < nmt) {
#pragma unroll
      for (int j = 0; j < kNC / 16; ++j) {
        if (j < nt)
          wmma::store_matrix_sync(Cs + j * 16 * kLdc + mt * 16, acc.c[i][j],
                                  kLdc, wmma::mem_col_major);
      }
    }
  }
}
__device__ __forceinline__ void acc_store(const Acc<float>& acc, int /*nmt*/,
                                          int /*nt*/, float* Cs) {
#pragma unroll
  for (int n = 0; n < kNC; ++n) Cs[n * kLdc + threadIdx.x] = acc.v[n];
}

// One convolution stage of a block. For the positions q_begin + m, m < 16 *
// nmt, of a channels-last tile with rows PW pixels wide:
//   Cs[n * kLdc + m] = sum_tap sum_{k < K} A[q_begin + m + shift(tap)][k]
//                                          * wts[tap][k][n0 + n]
// `filler.prepare(k0)` and, a barrier later, `filler.fill(k0)` bring channels
// [k0, k0 + kKC) into a_tile before each chunk; with `resident` the tile already holds all K channels (row stride
// lda) and the filler is a NoFiller. Ends with the block synchronised and Cs readable;
// the staged tile and weights are overwritten by Cs.
template <typename T, int PW, typename Filler>
__device__ void conv_accumulate(const Filler& filler, const T* a_tile, int lda,
                                bool resident, int K, const T* wts, int coutP,
                                int n0, int q_begin, int nmt, T* Ws,
                                float* Cs) {
  const int ncols = coutP - n0 < kNC ? coutP - n0 : kNC;
  const int nt = ncols / 16;
  Acc<T> acc;
  acc_zero(acc);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // the last chunk's (or the last epilogue's) readers
    filler.prepare(k0);
    stage_weights<T>(wts, K, coutP, k0, n0, Ws);
    __syncthreads();
    filler.fill(k0);
    __syncthreads();
    const int kc = K - k0 < kKC ? K - k0 : kKC;
    mma_chunk<PW>(resident ? a_tile + k0 : a_tile, lda, Ws, kc, q_begin, nmt,
                  nt, acc);
  }
  __syncthreads();
  acc_store(acc, nmt, nt, Cs);
  __syncthreads();
}

// Which image, tile row and tile column a block owns.
struct BlockPos {
  int b, y0, x0, tile;
};
template <int TH>
__device__ __forceinline__ BlockPos block_pos(int ntx, int nty) {
  int bid = blockIdx.x;
  BlockPos bp;
  bp.tile = bid % (ntx * nty);
  bp.x0 = (bid % ntx) * kTW;
  bid /= ntx;
  bp.y0 = (bid % nty) * TH;
  bp.b = bid / nty;
  return bp;
}

// Epilogue of a stage that writes a map: out[b, n0 + n, y, x] =
// T(relu?(Cs * scale + bias)) for the tile's positions that lie RING rings
// inside the haloed tile and inside the image. With KEEP the fp32 value is
// also left in Cs (0 at every other position), for the channel sums.
template <typename T, typename G, int RING, bool KEEP>
__device__ void write_map(float* Cs, int q_begin, int ncols, int n0, int cout,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, bool relu, T* out,
                          int b, int y0, int x0, int H, int W) {
  for (int e = threadIdx.x; e < ncols * kM; e += kThreads) {
    const int n = e / kM, m = e % kM;
    const int q = q_begin + m;
    const int ty = q / G::PW, tx = q % G::PW;
    const int y = y0 - G::HALO + ty, x = x0 - G::HALO + tx;
    const bool valid = ty >= RING && ty < G::PH - RING && tx >= RING &&
                       tx < G::PW - RING && y < H && x < W && n0 + n < cout;
    float v = 0.f;
    if (valid) {
      v = Cs[n * kLdc + m] * scale[n0 + n] + bias[n0 + n];
      if (relu) v = fmaxf(v, 0.f);
      out[((static_cast<size_t>(b) * cout + n0 + n) * H + y) * W + x] =
          from_f<T>(v);
    }
    if (KEEP) Cs[n * kLdc + m] = v;
  }
}


// One convolution stage as a kernel of its own, over the (virtual concat of
// the) parts: K3's wmma variant (gated), and both stages of K2's wmma
// variant beyond kNC output channels, where y1 does not fit in shared
// memory and goes through device memory (the first stage gated, and
// blending under UP0; the second on y1 with CSUM). A block owns a 7 x 32
// output tile and every output channel, in passes of kNC. With CSUM every
// pass also writes its channels' fp32 sums over the tile's outputs inside
// the image, after affine and ReLU and before rounding, to
// partial[b][tile][c], each thread summing one channel in position order.
struct StageParams {
  Parts parts;
  const float* gate_c;  // (B, C), already sigmoided
  const float* gmap;    // (B, H, W) spatial gate, from gate_map_kernel
  const void* w;        // (9, C, coutP) in T
  const float* scale;   // (cout,)
  const float* bias;    // (cout,)
  void* out;            // (B, cout, H, W)
  float* partial;       // (B, ntx * nty, cout) (CSUM)
  int B, H, W, C, cout, coutP, relu, gated, ntx, nty;
};

using GeoOne = Geo<7, 1>;

template <typename T, bool UP0, bool CSUM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<T>)
    conv_stage_kernel(const StageParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using G = GeoOne;
  using S = Smem<T, G>;
  float* gs = reinterpret_cast<float*>(smem + S::gs);
  T* tile = reinterpret_cast<T*>(smem + S::tile);
  T* Ws = reinterpret_cast<T*>(smem + S::ws);
  float* Cs = reinterpret_cast<float*>(smem + S::tile);
  const BlockPos bp = block_pos<G::TH>(p.ntx, p.nty);
  const int H = p.H, W = p.W, C = p.C;
  constexpr int q_begin = G::PW + 1;
  constexpr int nmt = ((G::TH - 1) * G::PW + kTW + 15) / 16;

  if (p.gated) load_gates<G>(p.gmap, bp.b, bp.y0, bp.x0, H, W, gs);
  const PartsFiller<T, G, UP0> fill{
      p.parts,  bp.b, bp.y0, bp.x0,
      H,        W,    C,     p.gated != 0,
      p.gate_c, gs,   reinterpret_cast<ChunkTable*>(smem + S::tab),
      tile,     S::lda};
  for (int n0 = 0; n0 < p.coutP; n0 += kNC) {
    conv_accumulate<T, G::PW>(fill, tile, S::lda, false, C,
                              static_cast<const T*>(p.w), p.coutP, n0, q_begin,
                              nmt, Ws, Cs);
    const int ncols = p.coutP - n0 < kNC ? p.coutP - n0 : kNC;
    write_map<T, G, 1, CSUM>(Cs, q_begin, ncols, n0, p.cout, p.scale, p.bias,
                             p.relu != 0, static_cast<T*>(p.out), bp.b, bp.y0,
                             bp.x0, H, W);
    if (CSUM) {
      __syncthreads();
      const int c = static_cast<int>(threadIdx.x);
      if (c < ncols && n0 + c < p.cout) {
        const float* row = Cs + c * kLdc;
        float s = 0.f;
        for (int m = 0; m < kM; ++m) s += row[m];
        p.partial[(static_cast<size_t>(bp.b) * p.ntx * p.nty + bp.tile) *
                      p.cout + n0 + c] = s;
      }
    }
  }
}

// Launches conv_stage_kernel over the map (the caller has launched the gate
// map of a gated stage).
template <typename T, bool UP0, bool CSUM>
cudaError_t launch_stage(const StageParams& p, cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<T, GeoOne>::one);
  void (*kernel)(const StageParams) = conv_stage_kernel<T, UP0, CSUM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(p.B) * p.ntx * p.nty;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  DCONV_LAUNCH(kernel, static_cast<unsigned>(grid), smem, stream, p);
  return cudaGetLastError();
}

}  // namespace dconv
