// Fused eval axial attention for Hopper (sm_90a): K1's two kernels. The
// bf16 path, at any L from 1 to 64 (padded to 32 or 64, the padded keys
// masked), is the TMA + wgmma + mma.sync kernel of axial_sm90.cuh (C entry
// axial_attention_sm90_fwd there); fp32, and shapes that one does not take
// (dv or head counts outside its set, channel counts that are not multiples
// of 8, misaligned inputs), run the first kernel below ("wmma" in
// ops/axial_attention.py `variant`), one thread block per length-L sequence.
//
// Replaces: eyediseasesegmentation_tpu/ops/axial_attention.py, `_kernel`
// (the Pallas TPU kernel behind `axial_attention`). It computes, with every
// BatchNorm folded into per-channel affines:
//   kq = aff(x_q . W_kq), v = aff(x_v . W_v)                  (projection)
//   per head: qr[d,j] = sum_i q[d,i] r_q[i,d,j], kr[d,j] = sum_i k[d,i] r_k[i,d,j],
//             dots[d,j] = sum_i q[d,i] k[j,i]
//   logits = s0 qr + s1 kr + s2 dots + sb;  attn = softmax_j(logits)
//   out[d,i] = sum_j attn[d,j] v[j,i];  kv[d,i] = sum_j attn[d,j] r_v[d,j,i]
//   y[d, h*dv+i] = os0 kv + os1 out + ob
// Inputs x_q (b, L, Cq), x_v (b, L, Cv) and W in the compute type T (fp32 or
// bf16); W columns head-major (permuted by the wrapper); affines, r_q, r_k in
// fp32; r_v transposed to (d, j, i) and rounded to T, as the Pallas kernel
// reads it. Accumulation is fp32 throughout.
//
// The first kernel keeps everything but x and y out of device memory: the
// projected (L, 2*dkq*H + dv*H) tile stays in shared memory in T, the logits
// of a group of heads in fp32 beside it (up to 130 KB: one block per SM), and
// the r tables are read through L2, each entry once per group of heads. The
// bf16 projection runs on wmma 16x16x16 from double-buffered cp.async
// staging, re-staging x for every 128-column pass; the fp32 one, and every
// attention stage, on the FMA units, each thread holding a register tile of
// 4 channels x the group's heads: in fp32 the FMA units keep the
// reference's rounding (the tensor cores would round to TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "axial_sm90.cuh"

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;
constexpr int kRowTiles = kMaxL / 16;
constexpr int kNC = 128;  // projection: output columns per pass (8 warps x 16)
constexpr int kKC = 32;   // projection: reduction depth per staged chunk
constexpr int kMaxDkq = 16;
constexpr int kMaxGroup = 8;

struct Params {
  const void* xq;
  const void* xv;
  const void* wkq;
  const void* wv;
  const float* kq_scale;
  const float* kq_bias;
  const float* v_scale;
  const float* v_bias;
  const float* rq;   // (dkq, L, L)
  const float* rk;   // (dkq, L, L)
  const void* rvt;   // (L, L, dv) in T
  const float* ls0;  // (H,)
  const float* ls1;
  const float* ls2;
  const float* lbs;
  const float* os0;  // (H*dv,)
  const float* os1;
  const float* obs;
  void* out;         // (b, L, H*dv) in T
  int L, cq, cv, heads, dkq, dv, group, ldp, p_bytes;
  int vec;  // bit 0: x_q/W_kq, bit 1: x_v/W_v take 16-byte staging loads
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

// 16-byte global -> shared copy that does not block the thread (cp.async);
// with valid == false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copies an R x C tile of a row-major bf16 matrix (leading dimension ld) to
// shared memory (leading dimension ldd), zero outside rows x cols. With vec
// the copy is cp.async in 16-byte pieces and completes at the caller's
// wait: the caller guarantees 16-byte aligned rows and cols, ld multiples
// of 8. Without vec it is plain element loads, complete on return.
template <int C>
__device__ __forceinline__ void stage(const bf16* __restrict__ src, int ld,
                                      int rows, int cols, int R, bf16* dst,
                                      int ldd, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < R * (C / 8); e += kThreads) {
      const int r = e / (C / 8), c = (e % (C / 8)) * 8;
      const bool valid = r < rows && c < cols;
      cp_async16(dst + r * ldd + c,
                 valid ? src + static_cast<size_t>(r) * ld + c : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C;
      dst[r * ldd + c] = (r < rows && c < cols)
                             ? src[static_cast<size_t>(r) * ld + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// Four consecutive values as fp32 (bf16: two 4-byte loads, so an even
// element offset is enough).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  v[0] = p[0];
  v[1] = p[1];
  v[2] = p[2];
  v[3] = p[3];
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// P[r][col0 + c] = T(scale[c] * (X[r,:] . W[:,c]) + bias[c]), r < L, c < N.
// X is (L, K) row-major, W is (K, N) row-major. Tensor cores, bf16 in, fp32
// accumulate; rows are padded to a multiple of 16 with zeros. The staged
// chunks are double-buffered: chunk k+1 is in flight while chunk k is
// multiplied.
__device__ void project(const bf16* __restrict__ X, int L, int K,
                        const bf16* __restrict__ W, int N,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, bf16* P, int ldp,
                        int col0, unsigned char* scratch, bool vec) {
  using namespace nvcuda;
  constexpr int ldx = kKC + 8;
  constexpr int ldw = kNC + 8;
  constexpr int ldc = kNC + 4;
  constexpr int xs_size = kMaxL * ldx, ws_size = kKC * ldw;
  bf16* Xs0 = reinterpret_cast<bf16*>(scratch);
  bf16* Ws0 = Xs0 + 2 * xs_size;
  float* Cs = reinterpret_cast<float*>(Ws0 + 2 * ws_size);
  const int Lp = (L + 15) & ~15;
  const int nrt = Lp / 16;
  const int warp = threadIdx.x / 32;

  for (int n0 = 0; n0 < N; n0 += kNC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles];
#pragma unroll
    for (int a = 0; a < kRowTiles; ++a) wmma::fill_fragment(acc[a], 0.f);
    auto load_chunk = [&](int k0, int buf) {
      stage<kKC>(X + k0, K, L, K - k0, Lp, Xs0 + buf * xs_size, ldx, vec);
      stage<kNC>(W + static_cast<size_t>(k0) * N + n0, N, K - k0, N - n0,
                 kKC, Ws0 + buf * ws_size, ldw, vec);
      cp_async_commit();
    };
    load_chunk(0, 0);
    for (int k0 = 0, buf = 0; k0 < K; k0 += kKC, buf ^= 1) {
      if (k0 + kKC < K) {
        load_chunk(k0 + kKC, buf ^ 1);
      } else {
        cp_async_commit();  // an empty group keeps "all but the newest" right
      }
      cp_async_wait_prior();
      __syncthreads();
      const bf16* Xs = Xs0 + buf * xs_size;
      const bf16* Ws = Ws0 + buf * ws_size;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, Ws + kk * ldw + warp * 16, ldw);
#pragma unroll
        for (int a = 0; a < kRowTiles; ++a) {
          if (a < nrt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                afrag;
            wmma::load_matrix_sync(afrag, Xs + a * 16 * ldx + kk, ldx);
            wmma::mma_sync(acc[a], afrag, bfrag, acc[a]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < kRowTiles; ++a) {
      if (a < nrt) {
        wmma::store_matrix_sync(Cs + a * 16 * ldc + warp * 16, acc[a], ldc,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L * kNC; e += kThreads) {
      const int r = e / kNC, c = e % kNC;
      if (n0 + c < N) {
        P[r * ldp + col0 + n0 + c] =
            __float2bfloat16(Cs[r * ldc + c] * scale[n0 + c] + bias[n0 + c]);
      }
    }
    __syncthreads();
  }
}

// fp32 version of the projection on the FMA units: each thread holds a
// (rows ty + 16a) x (cols tx + 16c) register tile of the output chunk.
__device__ void project(const float* __restrict__ X, int L, int K,
                        const float* __restrict__ W, int N,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float* P, int ldp,
                        int col0, unsigned char* scratch, bool /*vec*/) {
  constexpr int ldx = kKC + 1;
  float* Xs = reinterpret_cast<float*>(scratch);
  float* Ws = Xs + kMaxL * ldx;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nrt = (L + 15) / 16;

  for (int n0 = 0; n0 < N; n0 += kNC) {
    float acc[kRowTiles][kNC / 16];
#pragma unroll
    for (int a = 0; a < kRowTiles; ++a)
#pragma unroll
      for (int c = 0; c < kNC / 16; ++c) acc[a][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      for (int e = threadIdx.x; e < nrt * 16 * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC;
        Xs[r * ldx + kk] = (r < L && k0 + kk < K)
                               ? X[static_cast<size_t>(r) * K + k0 + kk]
                               : 0.f;
      }
      for (int e = threadIdx.x; e < kKC * kNC; e += kThreads) {
        const int kk = e / kNC, c = e % kNC;
        Ws[kk * kNC + c] = (k0 + kk < K && n0 + c < N)
                               ? W[static_cast<size_t>(k0 + kk) * N + n0 + c]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float w[kNC / 16];
#pragma unroll
        for (int c = 0; c < kNC / 16; ++c) w[c] = Ws[kk * kNC + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < kRowTiles; ++a) {
          if (a < nrt) {
            const float x = Xs[(ty + 16 * a) * ldx + kk];
#pragma unroll
            for (int c = 0; c < kNC / 16; ++c) acc[a][c] = fmaf(x, w[c], acc[a][c]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < kRowTiles; ++a) {
      const int r = ty + 16 * a;
      if (a < nrt && r < L) {
#pragma unroll
        for (int c = 0; c < kNC / 16; ++c) {
          const int n = n0 + tx + 16 * c;
          if (n < N) P[r * ldp + col0 + n] = acc[a][c] * scale[n] + bias[n];
        }
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    axial_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  unsigned char* scratch = smem + p.p_bytes;
  const int L = p.L, H = p.heads, dkq = p.dkq, dv = p.dv, ldp = p.ldp;
  const int nkq = H * 2 * dkq, nv = H * dv;
  const size_t seq = blockIdx.x;

  // 1. projections into the shared tile: columns [0, nkq) hold q,k per head
  //    (head-major: q then k, dkq each), columns [nkq, nkq + nv) hold v
  project(static_cast<const T*>(p.xq) + seq * L * p.cq, L, p.cq,
          static_cast<const T*>(p.wkq), nkq, p.kq_scale, p.kq_bias, P, ldp, 0,
          scratch, p.vec & 1);
  project(static_cast<const T*>(p.xv) + seq * L * p.cv, L, p.cv,
          static_cast<const T*>(p.wv), nv, p.v_scale, p.v_bias, P, ldp, nkq,
          scratch, p.vec & 2);

  float* S = reinterpret_cast<float*>(scratch);  // [group][L][L + 1]
  const int lds = L + 1;
  const T* rvt = static_cast<const T*>(p.rvt);
  T* out = static_cast<T*>(p.out) + seq * L * nv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int h0 = 0; h0 < H; h0 += p.group) {
    const int G = p.group;
    // 2. logits for the heads of this group; each r entry is read once and
    //    used by every head of the group
    for (int e = threadIdx.x; e < L * L; e += kThreads) {
      const int d = e / L, j = e % L;
      float rq[kMaxDkq], rk[kMaxDkq];
#pragma unroll
      for (int i = 0; i < kMaxDkq; ++i) {
        if (i < dkq) {
          rq[i] = p.rq[(static_cast<size_t>(i) * L + d) * L + j];
          rk[i] = p.rk[(static_cast<size_t>(i) * L + d) * L + j];
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const int h = h0 + g;
          const T* qd = P + d * ldp + h * 2 * dkq;
          const T* kd = qd + dkq;
          const T* kj = P + j * ldp + h * 2 * dkq + dkq;
          float qr = 0.f, kr = 0.f, dots = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxDkq; ++i) {
            if (i < dkq) {
              const float q = to_f(qd[i]);
              qr = fmaf(q, rq[i], qr);
              kr = fmaf(to_f(kd[i]), rk[i], kr);
              dots = fmaf(q, to_f(kj[i]), dots);
            }
          }
          S[(g * L + d) * lds + j] =
              p.ls0[h] * qr + p.ls1[h] * kr + p.ls2[h] * dots + p.lbs[h];
        }
      }
    }
    __syncthreads();

    // 3. row softmax over j (L <= 64: two entries per lane), rounded to T
    for (int row = warp; row < G * L; row += kWarps) {
      float* sr = S + row * lds;
      const float v0 = lane < L ? sr[lane] : -INFINITY;
      const float v1 = lane + 32 < L ? sr[lane + 32] : -INFINITY;
      float m = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e0 = lane < L ? expf(v0 - m) : 0.f;
      const float e1 = lane + 32 < L ? expf(v1 - m) : 0.f;
      float s = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float inv = 1.f / s;
      if (lane < L) sr[lane] = to_f(from_f<T>(e0 * inv));
      if (lane + 32 < L) sr[lane + 32] = to_f(from_f<T>(e1 * inv));
    }
    __syncthreads();

    // 4. out = attn.v and kv = attn.r_v, merged with the folded output
    //    affine and written head-major; each r_v entry serves the whole
    //    group. A thread holds 4 channels x the group's heads, so each
    //    attention weight it reads feeds 8 FMAs.
    if ((dv & 3) == 0) {
      const int dq = dv / 4;
      for (int e = threadIdx.x; e < L * dq; e += kThreads) {
        const int d = e / dq, i0 = (e % dq) * 4;
        float ao[kMaxGroup][4], ak[kMaxGroup][4];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
          for (int q = 0; q < 4; ++q) ao[g][q] = ak[g][q] = 0.f;
        const T* rv = rvt + static_cast<size_t>(d) * L * dv + i0;
        const T* vcol = P + nkq + h0 * dv + i0;
        const float* srow = S + d * lds;
        for (int j0 = 0; j0 < L; j0 += 8) {
          float r[8][4];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (j0 + u < L) {
              load4(rv + static_cast<size_t>(j0 + u) * dv, r[u]);
            } else {
              r[u][0] = r[u][1] = r[u][2] = r[u][3] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = j0 + u;
            if (j < L) {
#pragma unroll
              for (int g = 0; g < kMaxGroup; ++g) {
                if (g < G) {
                  const float a = srow[g * L * lds + j];
                  float v[4];
                  load4(vcol + j * ldp + g * dv, v);
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    ao[g][q] = fmaf(a, v[q], ao[g][q]);
                    ak[g][q] = fmaf(a, r[u][q], ak[g][q]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = (h0 + g) * dv + i0 + q;
              out[static_cast<size_t>(d) * nv + c] = from_f<T>(
                  ak[g][q] * p.os0[c] + ao[g][q] * p.os1[c] + p.obs[c]);
            }
          }
        }
      }
    } else {
    for (int e = threadIdx.x; e < L * dv; e += kThreads) {
      const int d = e / dv, i = e % dv;
      float acc_o[kMaxGroup], acc_k[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) acc_o[g] = acc_k[g] = 0.f;
      const T* rv = rvt + static_cast<size_t>(d) * L * dv + i;
      const T* vcol = P + nkq + h0 * dv + i;
      const float* srow = S + d * lds;
      for (int j = 0; j < L; ++j) {
        const float r = to_f(rv[static_cast<size_t>(j) * dv]);
        const T* vj = vcol + j * ldp;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float a = srow[g * L * lds + j];
            acc_o[g] = fmaf(a, to_f(vj[g * dv]), acc_o[g]);
            acc_k[g] = fmaf(a, r, acc_k[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const int c = (h0 + g) * dv + i;
          out[static_cast<size_t>(d) * nv + c] =
              from_f<T>(acc_k[g] * p.os0[c] + acc_o[g] * p.os1[c] + p.obs[c]);
        }
      }
    }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const Params& p, int b, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      axial_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  axial_attention_kernel<T><<<b, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. The caller has checked every shape; group
// divides heads, the shared-memory plan (ldp, p_bytes, smem) and the
// alignment flags (vec) are the wrapper's. Returns the launch's cudaError_t.
extern "C" int axial_attention_fwd(
    int dtype, const void* xq, const void* xv, const void* wkq, const void* wv,
    const void* kq_scale, const void* kq_bias, const void* v_scale,
    const void* v_bias, const void* rq, const void* rk, const void* rvt,
    const void* ls0, const void* ls1, const void* ls2, const void* lbs,
    const void* os0, const void* os1, const void* obs, void* out, int b, int L,
    int cq, int cv, int heads, int dkq, int dv, int group, int ldp,
    int p_bytes, int smem, int vec, void* stream) {
  if (L < 1 || L > kMaxL || dkq < 1 || dkq > kMaxDkq || group < 1 ||
      group > kMaxGroup || heads % group != 0 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.xq = xq;
  p.xv = xv;
  p.wkq = wkq;
  p.wv = wv;
  p.kq_scale = static_cast<const float*>(kq_scale);
  p.kq_bias = static_cast<const float*>(kq_bias);
  p.v_scale = static_cast<const float*>(v_scale);
  p.v_bias = static_cast<const float*>(v_bias);
  p.rq = static_cast<const float*>(rq);
  p.rk = static_cast<const float*>(rk);
  p.rvt = rvt;
  p.ls0 = static_cast<const float*>(ls0);
  p.ls1 = static_cast<const float*>(ls1);
  p.ls2 = static_cast<const float*>(ls2);
  p.lbs = static_cast<const float*>(lbs);
  p.os0 = static_cast<const float*>(os0);
  p.os1 = static_cast<const float*>(os1);
  p.obs = static_cast<const float*>(obs);
  p.out = out;
  p.L = L;
  p.cq = cq;
  p.cv = cv;
  p.heads = heads;
  p.dkq = dkq;
  p.dv = dv;
  p.group = group;
  p.ldp = ldp;
  p.p_bytes = p_bytes;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<bf16>(p, b, smem, s)
                                     : launch<float>(p, b, smem, s);
  return static_cast<int>(err);
}
