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
// conv3x3_sm90_kernel<false, false, false> (bf16, W % 8 == 0, 16-byte-aligned
// maps): TMA + wgmma, the body K3 and K2 share (conv_sm90.cuh, which says
// what bounds it and what its design does about that).
//
// conv3x3_kernel (fp32, and bf16 of other widths): the wmma / FMA implicit
// GEMM per 7 x 32 output tile described in decode_conv.cuh.

#include "conv_sm90.cuh"

namespace dconv {

struct Conv3x3Params {
  const void* x;      // (B, C, H, W)
  const void* w;      // (9, C, coutP) in T, tap-major, zero-padded columns
  const float* scale; // (cout,)
  const float* bias;  // (cout,)
  void* out;          // (B, cout, H, W)
  int B, H, W, C, cout, coutP, relu, ntx, nty;
};

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

// The sm90 body on one part, ungated.
cudaError_t launch_conv3x3_sm90(const void* x, const void* w,
                                const float* scale, const float* bias,
                                void* out, int B, int H, int W, int C,
                                int cout, int coutP, int relu,
                                cudaStream_t stream) {
  Sm90Args a{};
  a.parts.n = 1;
  a.parts.ptr[0] = x;
  a.parts.ch[0] = C;
  a.parts.off[1] = C;
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.coutP = coutP;
  a.relu = relu;
  return launch_conv_sm90<false, false, false>(a, stream);
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
