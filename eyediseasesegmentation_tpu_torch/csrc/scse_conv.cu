// scSE-gated 3x3 SAME convolution over a virtual channel concat + affine +
// optional ReLU for Hopper (sm_90a), NCHW.
//
// Replaces: eyediseasesegmentation_tpu/ops/pallas_scse_conv.py, `_kernel`
// (the Pallas TPU kernel behind `scse_conv3x3_bn_relu`), the decode node's
// attention1 + conv1 + BN + ReLU stage:
//   t = sum_c fp32(x_c) w_sse[c];  gate = gate_c[b, c] + sigmoid(t + b_sse)
//   y = relu?(scale * conv3x3(x * T(gate)) + bias)
// with x the concat of the parts, which exists only in shared memory, the
// gating product in the compute type T and fp32 accumulation.
//
// The sSE logit needs every channel of a pixel before the first product, and
// a haloed tile of all channels does not fit in shared memory, so the parts
// are read twice: by a first small kernel that writes the spatial gate of
// the whole map (decode_conv.cuh, gate_map_kernel), and by the convolution,
// chunk by chunk. Two convolution kernels, chosen by the wrapper from dtype,
// width, alignment and the parts' channel counts (ops/scse_conv.py
// `variant`):
//
// sm90 (bf16, W % 8 == 0, 16-byte-aligned parts, every part a multiple of
// 16 channels): conv3x3_sm90_kernel<GATE, false, false> of conv_sm90.cuh,
// TMA + wgmma; its producer warps gate each landed box in place.
//
// wmma (fp32, and bf16 of other shapes): conv_stage_kernel, the wmma / FMA
// implicit GEMM of decode_conv.cuh, which says what bounds it on this card.

#include "conv_sm90.cuh"

namespace dconv {

// The wmma variant: the gate map, then decode_conv.cuh's stage kernel.
template <typename T>
cudaError_t launch_scse_conv(const StageParams& p, const GateMapParams& g,
                             cudaStream_t stream) {
  if (p.gated) {
    const cudaError_t err = launch_gate_map<T>(g, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_stage<T, false, false>(p, stream);
}

// The sm90 variant: the gate map, then the sm90 body.
cudaError_t launch_scse_conv_sm90(const StageParams& p,
                                  const GateMapParams& g, cudaStream_t stream) {
  Sm90Args a{};
  a.parts = p.parts;
  a.gate_c = p.gated ? p.gate_c : nullptr;
  a.gmap = p.gated ? p.gmap : nullptr;
  a.w = p.w;
  a.scale = p.scale;
  a.bias = p.bias;
  a.out = p.out;
  a.B = p.B;
  a.H = p.H;
  a.W = p.W;
  a.cout = p.cout;
  a.coutP = p.coutP;
  a.relu = p.relu;
  if (!p.gated) return launch_conv_sm90<false, false, false>(a, stream);
  const cudaError_t err = launch_gate_map<bf16>(g, stream);
  if (err != cudaSuccess) return err;
  return launch_conv_sm90<true, false, false>(a, stream);
}

}  // namespace dconv

// dtype: 0 = fp32, 1 = bf16. parts/channels: the first nparts entries are
// the (B, channels[i], H, W) parts of the concat. gmap is (B, H, W) fp32
// scratch for the spatial gate (unused when gated is 0). variant 0 (wmma /
// FMA): w is (9, C, coutP) in the compute type, coutP a multiple of 16.
// variant 1 (sm90, bf16 only): w is sm90_weight_operand's (coutP / 64,
// ceil(C / 16), 9, 16, 64), W % 8 == 0, the parts, w and out 16-byte aligned
// and every part but the last a multiple of 16 channels. Returns the
// cudaError_t of the launches; cudaErrorInvalidValue for what the variant
// does not take.
extern "C" int scse_conv3x3_fwd(int dtype, int variant, int nparts,
                                const void* const* parts,
                                const int* channels, const void* gate_c,
                                const void* wsse, const void* bsse,
                                void* gmap, const void* w, const void* scale,
                                const void* bias, void* out, int B, int H,
                                int W, int cout, int coutP, int relu,
                                int gated, void* stream) {
  if (nparts < 1 || nparts > dconv::kMaxParts || B < 1 || H < 1 || W < 1 ||
      cout < 1 || coutP < cout || coutP % 16 != 0 ||
      (variant != 0 && variant != 1) || (variant == 1 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dconv::StageParams p;
  p.parts.n = nparts;
  p.parts.up0 = 0;
  p.parts.off[0] = 0;
  for (int i = 0; i < dconv::kMaxParts; ++i) {
    p.parts.ptr[i] = i < nparts ? parts[i] : nullptr;
    p.parts.ch[i] = i < nparts ? channels[i] : 0;
    p.parts.off[i + 1] = p.parts.off[i] + p.parts.ch[i];
  }
  p.gate_c = static_cast<const float*>(gate_c);
  p.gmap = static_cast<const float*>(gmap);
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.partial = nullptr;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = p.parts.off[nparts];
  p.cout = cout;
  p.coutP = coutP;
  p.relu = relu;
  p.gated = gated;
  p.ntx = (W + dconv::kTW - 1) / dconv::kTW;
  p.nty = (H + dconv::GeoOne::TH - 1) / dconv::GeoOne::TH;
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
    return static_cast<int>(dconv::launch_scse_conv_sm90(p, g, s));
  const cudaError_t err = dtype == 1
                              ? dconv::launch_scse_conv<dconv::bf16>(p, g, s)
                              : dconv::launch_scse_conv<float>(p, g, s);
  return static_cast<int>(err);
}
