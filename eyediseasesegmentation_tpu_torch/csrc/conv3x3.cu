// 3x3 SAME convolution + per-channel affine + optional ReLU for Hopper
// (sm_90a), one input map, NCHW.
//
// Replaces: eyediseasesegmentation_tpu/ops/pallas_conv.py, `_kernel` (the
// Pallas TPU kernel behind `conv3x3_bn_relu`): y = relu?(scale * conv3x3(x)
// + bias), fp32 accumulation, output in the input's type. No model calls
// it; it is the plain-convolution baseline the gated kernels are measured
// against. The design, and what bounds it on this card, is described in
// decode_conv.cuh: an implicit GEMM per 7 x 32 output tile, bf16 on the
// tensor cores (wmma), fp32 on the FMA units.

#include "decode_conv.cuh"

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

}  // namespace dconv

// dtype: 0 = fp32, 1 = bf16. w is (9, C, coutP) in that type with coutP a
// multiple of 16. Returns the launch's cudaError_t.
extern "C" int conv3x3_fwd(int dtype, const void* x, const void* w,
                           const void* scale, const void* bias, void* out,
                           int B, int H, int W, int C, int cout, int coutP,
                           int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cout < 1 || coutP < cout ||
      coutP % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
                              ? dconv::launch_conv3x3<dconv::bf16>(p, s)
                              : dconv::launch_conv3x3<float>(p, s);
  return static_cast<int>(err);
}
