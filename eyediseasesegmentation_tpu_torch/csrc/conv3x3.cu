// 3x3 SAME convolution + per-channel affine + optional ReLU for Hopper
// (sm_90a), one input map, NCHW.
//
// Replaces: eyediseasesegmentation_tpu/ops/pallas_conv.py:40, `_kernel` (the
// Pallas TPU kernel behind `conv3x3_bn_relu`): y = relu?(scale * conv3x3(x)
// + bias), fp32 accumulation, output in the input's type. No model calls
// it; it is the plain-convolution baseline the gated kernels are measured
// against. Two kernels, chosen by the wrapper from dtype, width and
// alignment (ops/conv.py `variant`):
//
// conv3x3_sm90_kernel (bf16, W % 8 == 0, 16-byte-aligned maps). What bounds
// it: at 448 -> 64 channels at 512x512, 24 images, the product is 3.25 TFLOP
// against 6.4 GB of input and output, so the tensor cores' 3.3 ms is the
// floor; what the card must move between L2 and shared memory to feed them
// is the next limit. Measured on the H100, the fill (copies and shifts)
// alone takes longer than the products alone, and the two overlap only in
// part: the fill sets the pace (PERF.md, section 6). The design:
//   - an implicit GEMM per block of 8 output rows x 64 pixels x 64 output
//     channels: two consumer warpgroups of 4 rows each multiply with
//     wgmma m64n64k16 (M = the 64 pixels of a row, N = 64 channels, K = 16
//     input channels), and two producer warps feed them;
//   - the input arrives by TMA into a ring of 2 stages of 16 input channels,
//     with full/empty mbarriers. A 4-D tensor map over NCHW with its
//     dimensions ordered (W, C, H, B) lands a box of (64 px, 16 channels,
//     10 rows) as [row][channel][64 px]: 128-byte lines, swizzled by the
//     TMA, which is wgmma's M-major A operand as it is. There is no transpose
//     and no scalar load; SAME padding is the TMA's zero fill of coordinates
//     outside the map (negative ones included). Tap dy is a whole-row offset
//     into the box. Tap dx needs the box at x0 - 1 and x0 + 1 too, which the
//     TMA cannot load (the card faults on a box whose W coordinate is not a
//     multiple of 8): the producer warps build them from the box at x0 and
//     the 8 pixels on either side (two small boxes at x0 - 8 and x0 + 64),
//     shifting each 128-byte line by one pixel with 16-byte shared-memory
//     loads and stores that the swizzle keeps free of bank conflicts;
//   - the weights of a chunk (9 taps x 16 x 64, 18 KB) arrive by one bulk
//     copy, arranged and swizzled by the wrapper into wgmma's N-major B
//     operand (ops/conv.py `sm90_weight_operand`);
//   - the epilogue applies scale, bias and ReLU to the fp32 sums in
//     registers, rounds once, stages the tile in shared memory (the ring,
//     which is free by then) and writes every channel's row of 64 px as
//     16-byte stores.
//   A block moves 43 KB from L2 per chunk for 512 outputs x 64 channels:
//   each input value is read 1.25 times (the dy halo) plus the edges, and
//   each chunk's weights are staged once per block, not per 32 channels as
//   the wmma kernel did.
//
// conv3x3_kernel (fp32, and bf16 of other widths): the wmma / FMA implicit
// GEMM per 7 x 32 output tile described in decode_conv.cuh.

#include <sm90.cuh>

#include "decode_conv.cuh"

// How a kernel with its own thread count is launched. A host-side emulation
// of the device code may define it otherwise.
#ifndef DCONV_LAUNCH_T
#define DCONV_LAUNCH_T(kernel, grid, threads, smem, stream, params) \
  kernel<<<grid, threads, smem, stream>>>(params)
#endif

namespace dconv {

struct Conv3x3Params {
  const void* x;      // (B, C, H, W)
  const void* w;      // (9, C, coutP) in T, tap-major, zero-padded columns
  const float* scale; // (cout,)
  const float* bias;  // (cout,)
  void* out;          // (B, cout, H, W)
  int B, H, W, C, cout, coutP, relu, ntx, nty;
};

using GeoOne = Geo<7, 1>;

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<T>)
    conv3x3_kernel(const Conv3x3Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using G = GeoOne;
  using S = Smem<T, G>;
  T* tile = reinterpret_cast<T*>(smem + S::tile);
  T* Ws = reinterpret_cast<T*>(smem + S::ws);
  float* Cs = reinterpret_cast<float*>(smem + S::tile);
  const BlockPos bp = block_pos<G::TH>(p.ntx, p.nty);
  const int H = p.H, W = p.W, C = p.C;
  constexpr int q_begin = G::PW + 1;
  constexpr int nmt = ((G::TH - 1) * G::PW + kTW + 15) / 16;

  Parts one;  // the input as a concat of one part
  one.n = 1;
  one.up0 = 0;
  one.ptr[0] = p.x;
  one.ch[0] = C;
  one.off[0] = 0;
  one.off[1] = C;
  const PartsFiller<T, G, false> fill{one,     bp.b,    bp.y0,   bp.x0, H,
                                      W,       C,       false,   nullptr,
                                      nullptr, reinterpret_cast<ChunkTable*>(smem + S::tab),
                                      tile,    S::lda};
  for (int n0 = 0; n0 < p.coutP; n0 += kNC) {
    conv_accumulate<T, G::PW>(fill, tile, S::lda, false, C,
                              static_cast<const T*>(p.w), p.coutP, n0, q_begin,
                              nmt, Ws, Cs);
    const int ncols = p.coutP - n0 < kNC ? p.coutP - n0 : kNC;
    write_map<T, G, 1, false>(Cs, q_begin, ncols, n0, p.cout, p.scale, p.bias,
                              p.relu != 0, static_cast<T*>(p.out), bp.b, bp.y0,
                              bp.x0, H, W);
  }
}

template <typename T>
cudaError_t launch_conv3x3(const Conv3x3Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<T, GeoOne>::one);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(p.B) * p.ntx * p.nty;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  DCONV_LAUNCH(conv3x3_kernel<T>, static_cast<unsigned>(grid), smem, stream, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// conv3x3_sm90_kernel
// ---------------------------------------------------------------------------

namespace s90 {
constexpr int kRows = 4;                     // output rows per warpgroup
constexpr int kWG = 2;                       // consumer warpgroups
constexpr int kTH = kRows * kWG;             // output rows per block
constexpr int kPX = 64;                      // output pixels per row (M)
constexpr int kN = 64;                       // output channels per block (N)
constexpr int kKS = 16;                      // input channels per stage (K)
constexpr int kStages = 2;
constexpr int kPW = 2;                       // producer warps
constexpr int kBlockThreads = 128 * kWG + 32 * kPW;
constexpr int kLine = 128;                   // bytes of 64 bf16 values
constexpr int kBoxRows = kTH + 2;             // rows one box loads
constexpr int kLines = kBoxRows * kKS;        // 128-byte lines of a box
constexpr int kRow = kKS * kLine;             // one row of a box: 2 KB
constexpr int kBox = kLines * kLine;          // one box: 20 KB
constexpr int kEdge = kLines * 16;            // 8 px of a box's lines: 2.5 KB
constexpr int kWOff = 3 * kBox + 2 * kEdge;   // where the weights start
constexpr int kWBytes = 9 * kKS * kLine;      // one chunk's weights: 18 KB
constexpr int kStage = kWOff + kWBytes;       // 83 KB
constexpr int kLdo = kPX + 8;                 // staged output row, in values
constexpr int kSmem = 1024 + kStages * kStage + 3 * kStages * 8;
static_assert(kBox % 1024 == 0 && kWOff % 1024 == 0 && kStage % 1024 == 0,
              "every operand starts on a 1024-byte swizzle atom");
static_assert(kWG * kRows * kN * kLdo * 2 <= kStages * kStage,
              "the staged output fits in the ring");
}  // namespace s90

struct Conv3x3Sm90Params {
  CUtensorMap xmap;    // x as (W, C, H, B), box (64, kKS, kBoxRows, 1), swizzled
  CUtensorMap emap;    // the same, box (8, kKS, kBoxRows, 1), not swizzled
  const bf16* w;       // (npass, nchunk, 9, kKS, 64), sm90_weight_operand
  const float* scale;  // (cout,)
  const float* bias;   // (cout,)
  bf16* out;           // (B, cout, H, W)
  int B, H, W, cout, nchunk, ntx, nty, relu;
};

// The dx = 0 and dx = 2 boxes from the dx = 1 box c: each 128-byte line
// shifted one pixel to the right (d0; pixel 0 from element 7 of the left
// edge's line) and one to the left (d2; pixel 63 from element 0 of the right
// edge's line). c, d0 and d2 are 128-byte swizzled (16-byte piece j of line
// l at piece j ^ (l % 8)), so lanes on 8 consecutive lines touch distinct
// banks; the edges are plain 16-byte lines. Words hold two pixels, the
// lower one in the low half.
__device__ __forceinline__ void shift_boxes(const unsigned char* c,
                                            const unsigned char* eleft,
                                            const unsigned char* eright,
                                            unsigned char* d0,
                                            unsigned char* d2, int lane) {
  using namespace s90;
  for (int l = lane; l < kLines; l += 32 * kPW) {
    const int sw = l % 8;
    uint32_t w[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(c + l * kLine + 16 * (j ^ sw));
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
    const uint32_t lo =
        *reinterpret_cast<const uint16_t*>(eleft + l * 16 + 14);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(eright + l * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t r[4], f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        r[q] = (w[i] << 16) | (i == 0 ? lo : w[i - 1] >> 16);
        f[q] = (w[i] >> 16) | ((i == 31 ? hi : w[i + 1] & 0xFFFFu) << 16);
      }
      *reinterpret_cast<uint4*>(d0 + l * kLine + 16 * (j ^ sw)) =
          make_uint4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<uint4*>(d2 + l * kLine + 16 * (j ^ sw)) =
          make_uint4(f[0], f[1], f[2], f[3]);
    }
  }
}

__global__ void __launch_bounds__(s90::kBlockThreads, 1)
    conv3x3_sm90_kernel(const __grid_constant__ Conv3x3Sm90Params p) {
  using namespace s90;
  extern __shared__ __align__(128) unsigned char smem[];
  // the swizzle is a function of the address: operands start 1024-aligned
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;  // the dx = 1 box and the edges

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
    const bf16* wsrc =
        p.w + static_cast<size_t>(pass) * p.nchunk * (kWBytes / 2);
    for (int kc = 0; kc < p.nchunk; ++kc) {
      const int s = kc % kStages;
      const uint32_t parity = (kc / kStages) & 1;
      sm90::mbar_wait(&empty[s], parity ^ 1);
      unsigned char* st = ring + s * kStage;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&landed[s], kBox + 2 * kEdge);
        sm90::tma_load_4d(st + kBox, &p.xmap, &landed[s], x0, kc * kKS,
                          y0 - 1, b);
        sm90::tma_load_4d(st + 3 * kBox, &p.emap, &landed[s], x0 - 8,
                          kc * kKS, y0 - 1, b);
        sm90::tma_load_4d(st + 3 * kBox + kEdge, &p.emap, &landed[s],
                          x0 + kPX, kc * kKS, y0 - 1, b);
        sm90::mbar_arrive_expect_tx(&full[s], kWBytes);
        sm90::bulk_load(st + kWOff,
                        wsrc + static_cast<size_t>(kc) * (kWBytes / 2),
                        kWBytes, &full[s]);
      }
      sm90::mbar_wait(&landed[s], parity);
      shift_boxes(st + kBox, st + 3 * kBox, st + 3 * kBox + kEdge, st,
                  st + 2 * kBox, lane);
      sm90::fence_proxy_async();  // the shifted boxes are seen by wgmma
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
    const unsigned char* st = ring + s * kStage;
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
  // rounded outputs as [row][channel][kLdo]
  sm90::bar_sync(1, 128 * kWG);
  const int t = threadIdx.x % 128, lane = t % 32, wl = t / 32;
  bf16* stg = reinterpret_cast<bf16*>(ring) + wg * kRows * kN * kLdo;
  const int n0 = pass * kN;
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
    }
  }
  sm90::bar_sync(2 + wg, 128);
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

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

cudaError_t launch_conv3x3_sm90(const void* x, const void* w,
                                const float* scale, const float* bias,
                                void* out, int B, int H, int W, int C,
                                int cout, int coutP, int relu,
                                cudaStream_t stream) {
  using namespace s90;
  // TMA: 16-byte-aligned base and row strides; the 16-byte stores of the
  // epilogue and the bulk copy of the weights: the same for out and w
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (W % 8 != 0 || !aligned(x) || !aligned(w) || !aligned(out) ||
      coutP % kN != 0)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  Conv3x3Sm90Params p;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t plane = static_cast<cuuint64_t>(H) * W * 2;
  const cuuint64_t strides[3] = {plane, static_cast<cuuint64_t>(W) * 2,
                                 plane * C};
  const cuuint32_t box[4] = {kPX, kKS, kBoxRows, 1};
  const cuuint32_t edge[4] = {8, kKS, kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&p.emap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, edge, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  p.w = static_cast<const bf16*>(w);
  p.scale = scale;
  p.bias = bias;
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cout = cout;
  p.nchunk = (C + kKS - 1) / kKS;
  p.ntx = (W + kPX - 1) / kPX;
  p.nty = (H + kTH - 1) / kTH;
  p.relu = relu;
  const long long grid =
      static_cast<long long>(coutP / kN) * B * p.nty * p.ntx;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  DCONV_LAUNCH_T(conv3x3_sm90_kernel, static_cast<unsigned>(grid), kBlockThreads,
                 kSmem, stream, p);
  return cudaGetLastError();
}

}  // namespace dconv

// dtype: 0 = fp32, 1 = bf16. variant 0 (wmma / FMA): w is (9, C, coutP) in
// that type, tap-major, with coutP a multiple of 16. variant 1 (sm90, bf16
// only): w is sm90_weight_operand's (coutP / 64, ceil(C / 16), 9, 16, 64),
// and W % 8 == 0 with x, w and out 16-byte aligned. Returns the launch's
// cudaError_t; cudaErrorInvalidValue for what the variant does not take.
extern "C" int conv3x3_fwd(int dtype, int variant, const void* x,
                           const void* w, const void* scale, const void* bias,
                           void* out, int B, int H, int W, int C, int cout,
                           int coutP, int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cout < 1 || coutP < cout ||
      coutP % 16 != 0 || (variant != 0 && variant != 1) ||
      (variant == 1 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    return static_cast<int>(dconv::launch_conv3x3_sm90(
        x, w, static_cast<const float*>(scale), static_cast<const float*>(bias),
        out, B, H, W, C, cout, coutP, relu, s));
  }
  dconv::Conv3x3Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.cout = cout;
  p.coutP = coutP;
  p.relu = relu;
  p.ntx = (W + dconv::kTW - 1) / dconv::kTW;
  p.nty = (H + dconv::GeoOne::TH - 1) / dconv::GeoOne::TH;
  const cudaError_t err = dtype == 1
                              ? dconv::launch_conv3x3<dconv::bf16>(p, s)
                              : dconv::launch_conv3x3<float>(p, s);
  return static_cast<int>(err);
}
