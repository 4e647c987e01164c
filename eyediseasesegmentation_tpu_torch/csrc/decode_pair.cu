// The decode node's two convolutions for Hopper (sm_90a), NCHW.
//
// Replaces: eyediseasesegmentation_tpu/ops/pallas_decode_pair.py, `_kernel`
// (the Pallas TPU kernel behind `scse_conv3x3_pair`):
//   y1 = relu?(scale1 * conv3x3(cat(parts) * T(scse gate)) + bias1)
//   y2 = relu?(scale2 * conv3x3(y1) + bias2)
//   csum[b, c] = sum over pixels of y2[b, c] in fp32, before its rounding
// y1 is rounded to the compute type T between the convolutions and zero
// outside the image (SAME padding of the second convolution, not
// relu(bias1)). With up0, part 0 arrives at half height and the H direction
// of its bilinear x2 is taken while the input is staged. Two variants,
// chosen by the wrapper from dtype, width, alignment and the parts' channel
// counts (ops/decode_pair.py `variant`):
//
// sm90 (bf16, W % 8 == 0, 16-byte-aligned parts, every part a multiple of
// 16 channels): two launches of conv_sm90.cuh's TMA + wgmma body. The first
// (GATE, and UP0 under up0) writes y1 to a bf16 scratch map in device
// memory; the second reads it back by TMA, whose zero fill is y1's padding,
// and its CSUM epilogue writes the channel sums of each output tile. y1 goes
// through device memory rather than staying in shared memory: a resident y1
// with its ring for the 8 x 64 output tile (84 KB) does not fit beside the
// two 83 KB stages of the ring (232,448 bytes a block), and recomputing the
// ring costs 1.29x the first convolution's products, while writing and
// reading y1 costs 1.6 GB at x_1_3 (about 0.5 ms at 3.35 TB/s).
//
// wmma (fp32, and bf16 of other shapes): up to 64 output channels,
// decode_pair_kernel, one kernel in which a block computes y1 on its 5 x 32
// output tile plus one ring, from an input tile with two rings, keeps it
// channels-last in shared memory and runs the second convolution from
// there. The ring is recomputed by neighbouring blocks (1.5x the first
// stage's products). Beyond 64 output channels y1 does not fit in shared
// memory, so it goes through a scratch map in device memory, as in the sm90
// variant: decode_conv.cuh's stage kernel writes it (gated, blending under
// up0) and runs the second convolution on it with the channel-sum
// epilogue, both in passes of 64 output channels. The GEMM, and what bounds
// it on this card, is described in decode_conv.cuh.
//
// csum: every block writes the sums of its tile to partial[b][tile][c] in a
// fixed order, and a second small kernel adds the tiles of an image in tile
// order, so the result does not change from run to run (no float atomics).

#include "conv_sm90.cuh"

namespace dconv {

struct PairParams {
  Parts parts;
  const float* gate_c;  // (B, C), already sigmoided
  const float* gmap;    // (B, H, W) spatial gate, from gate_map_kernel
  const void* w1;       // (9, C, coutP) in T
  const float* scale1;  // (cout,)
  const float* bias1;
  const void* w2;       // (9, coutP, coutP) in T
  const float* scale2;
  const float* bias2;
  void* out;            // (B, cout, H, W)
  float* partial;       // (B, ntx * nty, cout)
  float* csum;          // (B, cout)
  int B, H, W, C, cout, coutP, relu, gated, ntx, nty;
};

using GeoPair = Geo<5, 2>;

template <typename T, bool UP0>
__global__ void __launch_bounds__(kThreads)
    decode_pair_kernel(const PairParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using G = GeoPair;
  using S = Smem<T, G>;
  float* gs = reinterpret_cast<float*>(smem + S::gs);
  T* tile = reinterpret_cast<T*>(smem + S::tile);
  T* Ws = reinterpret_cast<T*>(smem + S::ws);
  float* Cs = reinterpret_cast<float*>(smem + S::tile);
  T* y1 = reinterpret_cast<T*>(smem + S::y1);
  const BlockPos bp = block_pos<G::TH>(p.ntx, p.nty);
  const int H = p.H, W = p.W, C = p.C, cout = p.cout, coutP = p.coutP;
  const bool relu = p.relu != 0;

  // stage 1: y1 on the tile plus one ring, positions (ty, tx) in
  // [1, TH + 2] x [1, kTW + 2] of the haloed tile
  constexpr int q1 = G::PW + 1;
  constexpr int nmt1 = ((G::TH + 1) * G::PW + kTW + 2 + 15) / 16;
  static_assert(nmt1 * 16 <= kM, "stage 1 does not fit the block");
  if (p.gated) load_gates<G>(p.gmap, bp.b, bp.y0, bp.x0, H, W, gs);
  const PartsFiller<T, G, UP0> fill{
      p.parts,  bp.b, bp.y0, bp.x0,
      H,        W,    C,     p.gated != 0,
      p.gate_c, gs,   reinterpret_cast<ChunkTable*>(smem + S::tab),
      tile,     S::lda};
  conv_accumulate<T, G::PW>(fill, tile, S::lda, false, C,
                            static_cast<const T*>(p.w1), coutP, 0, q1, nmt1,
                            Ws, Cs);
  for (int e = threadIdx.x; e < coutP * kM; e += kThreads) {
    const int n = e / kM, m = e % kM;
    const int q = q1 + m;
    const int ty = q / G::PW, tx = q % G::PW;
    const int y = bp.y0 - G::HALO + ty, x = bp.x0 - G::HALO + tx;
    float v = 0.f;
    if (ty >= 1 && ty < G::PH - 1 && tx >= 1 && tx < G::PW - 1 && y >= 0 &&
        y < H && x >= 0 && x < W && n < cout) {
      v = Cs[n * kLdc + m] * p.scale1[n] + p.bias1[n];
      if (relu) v = fmaxf(v, 0.f);
    }
    y1[q * S::ld1 + n] = from_f<T>(v);
  }

  // stage 2: y2 on the tile, positions [2, TH + 1] x [2, kTW + 1]
  constexpr int q2 = 2 * G::PW + 2;
  constexpr int nmt2 = ((G::TH - 1) * G::PW + kTW + 15) / 16;
  conv_accumulate<T, G::PW>(NoFiller{}, y1, S::ld1, true, coutP,
                            static_cast<const T*>(p.w2), coutP, 0, q2, nmt2,
                            Ws, Cs);
  write_map<T, G, 2, true>(Cs, q2, coutP, 0, cout, p.scale2, p.bias2, relu,
                           static_cast<T*>(p.out), bp.b, bp.y0, bp.x0, H, W);
  __syncthreads();
  const int c = static_cast<int>(threadIdx.x);
  if (c < cout) {
    const float* row = Cs + c * kLdc;
    float s = 0.f;
    for (int m = 0; m < nmt2 * 16; ++m) s += row[m];
    p.partial[(static_cast<size_t>(bp.b) * p.ntx * p.nty + bp.tile) * cout + c] = s;
  }
}

// csum[b, c] = sum of partial[b, tile, c] over the tiles, in tile order.
struct CsumParams {
  const float* partial;  // (B, ntiles, cout)
  float* csum;           // (B, cout)
  int B, ntiles, cout;
};

__global__ void csum_reduce_kernel(const CsumParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B * p.cout) return;
  const int b = i / p.cout, c = i % p.cout;
  const float* src = p.partial + static_cast<size_t>(b) * p.ntiles * p.cout + c;
  float s = 0.f;
  for (int t = 0; t < p.ntiles; ++t) s += src[static_cast<size_t>(t) * p.cout];
  p.csum[i] = s;
}

inline cudaError_t launch_csum_reduce(const PairParams& p, int ntiles,
                                      cudaStream_t stream) {
  const CsumParams c{p.partial, p.csum, p.B, ntiles, p.cout};
  const unsigned grid =
      static_cast<unsigned>((p.B * p.cout + kThreads - 1) / kThreads);
  DCONV_LAUNCH(csum_reduce_kernel, grid, 0, stream, c);
  return cudaGetLastError();
}

template <typename T, bool UP0>
cudaError_t launch_pair(const PairParams& p, const GateMapParams& g,
                        cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<T, GeoPair>::pair);
  void (*kernel)(const PairParams) = decode_pair_kernel<T, UP0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(p.B) * p.ntx * p.nty;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  if (p.gated) {
    err = launch_gate_map<T>(g, stream);
    if (err != cudaSuccess) return err;
  }
  DCONV_LAUNCH(kernel, static_cast<unsigned>(grid), smem, stream, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_csum_reduce(p, p.ntx * p.nty, stream);
}

// The wmma variant beyond 64 output channels: the gate map; y1 by the stage
// kernel, gated (and blending), into the scratch map; y2 and its tiles'
// sums by the stage kernel on y1 (w2 is (9, cout, coutP)); the tiles' sums
// in order.
template <typename T, bool UP0>
cudaError_t launch_pair_wide(const PairParams& p, const GateMapParams& g,
                             void* y1, cudaStream_t stream) {
  StageParams a{};
  a.parts = p.parts;
  a.gate_c = p.gate_c;
  a.gmap = p.gmap;
  a.w = p.w1;
  a.scale = p.scale1;
  a.bias = p.bias1;
  a.out = y1;
  a.B = p.B;
  a.H = p.H;
  a.W = p.W;
  a.C = p.C;
  a.cout = p.cout;
  a.coutP = p.coutP;
  a.relu = p.relu;
  a.gated = p.gated;
  a.ntx = (p.W + kTW - 1) / kTW;
  a.nty = (p.H + GeoOne::TH - 1) / GeoOne::TH;
  cudaError_t err = cudaSuccess;
  if (p.gated) err = launch_gate_map<T>(g, stream);
  if (err != cudaSuccess) return err;
  err = launch_stage<T, UP0, false>(a, stream);
  if (err != cudaSuccess) return err;
  StageParams b = a;
  b.parts = Parts{};
  b.parts.n = 1;
  b.parts.ptr[0] = y1;
  b.parts.ch[0] = p.cout;
  b.parts.off[1] = p.cout;
  b.gated = 0;
  b.w = p.w2;
  b.scale = p.scale2;
  b.bias = p.bias2;
  b.out = p.out;
  b.partial = p.partial;
  b.C = p.cout;
  err = launch_stage<T, false, true>(b, stream);
  if (err != cudaSuccess) return err;
  return launch_csum_reduce(p, a.ntx * a.nty, stream);
}

// The sm90 variant: the gate map; y1 by the gated (and blending) sm90 body
// into the scratch map; y2 and its tile sums by the sm90 body on y1; the
// tiles' sums in order.
cudaError_t launch_pair_sm90(const PairParams& p, const GateMapParams& g,
                             void* y1, cudaStream_t stream) {
  Sm90Args a{};
  a.parts = p.parts;
  a.gate_c = p.gated ? p.gate_c : nullptr;
  a.gmap = p.gated ? p.gmap : nullptr;
  a.w = p.w1;
  a.scale = p.scale1;
  a.bias = p.bias1;
  a.out = y1;
  a.B = p.B;
  a.H = p.H;
  a.W = p.W;
  a.cout = p.cout;
  a.coutP = p.coutP;
  a.relu = p.relu;
  cudaError_t err = cudaSuccess;
  if (p.gated) err = launch_gate_map<bf16>(g, stream);
  if (err != cudaSuccess) return err;
  if (p.parts.up0)
    err = p.gated ? launch_conv_sm90<true, true, false>(a, stream)
                  : launch_conv_sm90<false, true, false>(a, stream);
  else
    err = p.gated ? launch_conv_sm90<true, false, false>(a, stream)
                  : launch_conv_sm90<false, false, false>(a, stream);
  if (err != cudaSuccess) return err;
  Sm90Args b = a;
  b.parts = Parts{};
  b.parts.n = 1;
  b.parts.ptr[0] = y1;
  b.parts.ch[0] = p.cout;
  b.parts.off[1] = p.cout;
  b.gate_c = b.gmap = nullptr;
  b.w = p.w2;
  b.scale = p.scale2;
  b.bias = p.bias2;
  b.out = p.out;
  b.partial = p.partial;
  err = launch_conv_sm90<false, false, true>(b, stream);
  if (err != cudaSuccess) return err;
  return launch_csum_reduce(p, sm90_tiles(p.H, p.W), stream);
}

}  // namespace dconv

// Tiles a variant cuts an (H, W) map into, so that the caller can size
// `partial` (wmma: the one-kernel form's, which are at least as many as the
// stage kernel's beyond 64 output channels).
extern "C" int decode_pair_tiles(int variant, int H, int W) {
  if (variant == 1) return dconv::sm90_tiles(H, W);
  return ((W + dconv::kTW - 1) / dconv::kTW) *
         ((H + dconv::GeoPair::TH - 1) / dconv::GeoPair::TH);
}

// dtype: 0 = fp32, 1 = bf16. parts/channels: the first nparts entries are
// the parts of the concat, (B, channels[i], H, W), or (B, channels[0], H/2,
// W) for part 0 under up0. partial is (B, decode_pair_tiles(variant, H, W),
// cout) and gmap (B, H, W) fp32 scratch (gmap unused when gated is 0).
// variant 0 (wmma / FMA): w1 is (9, C, coutP) in the compute type,
// zero-padded, coutP a multiple of 16; up to coutP 64, w2 is (9, coutP,
// coutP) and y1 unused; beyond, w2 is (9, cout, coutP) and y1 (B, cout, H,
// W) scratch in the compute type. variant 1 (sm90, bf16 only): w1 and w2 are
// sm90_weight_operand's, coutP a multiple of 64, y1 (B, cout, H, W) bf16
// scratch, W % 8 == 0, the parts, weights, y1 and out 16-byte aligned and
// every part but the last a multiple of 16 channels. Returns the
// cudaError_t of the launches; cudaErrorInvalidValue for what the variant
// does not take.
extern "C" int decode_pair_fwd(int dtype, int variant, int nparts,
                               const void* const* parts, const int* channels,
                               int up0, const void* gate_c, const void* wsse,
                               const void* bsse, void* gmap, const void* w1,
                               const void* scale1, const void* bias1,
                               const void* w2, const void* scale2,
                               const void* bias2, void* y1, void* out,
                               void* partial, void* csum, int B, int H, int W,
                               int cout, int coutP, int relu, int gated,
                               void* stream) {
  if (nparts < 1 || nparts > dconv::kMaxParts || B < 1 || H < 1 || W < 1 ||
      cout < 1 || coutP < cout || coutP % 16 != 0 || (up0 && (H & 1)) ||
      (variant != 0 && variant != 1) ||
      (variant == 0 && coutP > dconv::kNC && y1 == nullptr) ||
      (variant == 1 && (dtype != 1 || y1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dconv::PairParams p;
  p.parts.n = nparts;
  p.parts.up0 = up0;
  p.parts.off[0] = 0;
  for (int i = 0; i < dconv::kMaxParts; ++i) {
    p.parts.ptr[i] = i < nparts ? parts[i] : nullptr;
    p.parts.ch[i] = i < nparts ? channels[i] : 0;
    p.parts.off[i + 1] = p.parts.off[i] + p.parts.ch[i];
  }
  p.gate_c = static_cast<const float*>(gate_c);
  p.gmap = static_cast<const float*>(gmap);
  p.w1 = w1;
  p.scale1 = static_cast<const float*>(scale1);
  p.bias1 = static_cast<const float*>(bias1);
  p.w2 = w2;
  p.scale2 = static_cast<const float*>(scale2);
  p.bias2 = static_cast<const float*>(bias2);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.csum = static_cast<float*>(csum);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = p.parts.off[nparts];
  p.cout = cout;
  p.coutP = coutP;
  p.relu = relu;
  p.gated = gated;
  p.ntx = (W + dconv::kTW - 1) / dconv::kTW;
  p.nty = (H + dconv::GeoPair::TH - 1) / dconv::GeoPair::TH;
  dconv::GateMapParams g;
  g.parts = p.parts;
  g.wsse = static_cast<const float*>(wsse);
  g.bsse = static_cast<const float*>(bsse);
  g.gmap = static_cast<float*>(gmap);
  g.B = B;
  g.H = H;
  g.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return static_cast<int>(dconv::launch_pair_sm90(p, g, y1, s));
  cudaError_t err;
  if (coutP > dconv::kNC) {
    if (dtype == 1)
      err = up0 ? dconv::launch_pair_wide<dconv::bf16, true>(p, g, y1, s)
                : dconv::launch_pair_wide<dconv::bf16, false>(p, g, y1, s);
    else
      err = up0 ? dconv::launch_pair_wide<float, true>(p, g, y1, s)
                : dconv::launch_pair_wide<float, false>(p, g, y1, s);
    return static_cast<int>(err);
  }
  if (dtype == 1) {
    err = up0 ? dconv::launch_pair<dconv::bf16, true>(p, g, s)
              : dconv::launch_pair<dconv::bf16, false>(p, g, s);
  } else {
    err = up0 ? dconv::launch_pair<float, true>(p, g, s)
              : dconv::launch_pair<float, false>(p, g, s);
  }
  return static_cast<int>(err);
}
