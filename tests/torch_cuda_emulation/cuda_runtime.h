// Host stand-in for <cuda_runtime.h>, for rehearsing the port's CUDA sources
// without a GPU: every CUDA thread of a block is a std::thread, __syncthreads
// is a std::barrier, blocks run one after another. Only what the sources in
// eyediseasesegmentation_tpu_torch/csrc/decode_conv.cuh and its users need.
#pragma once
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
#define __grid_constant__
#define CUDART_VERSION 12080

struct EmuDim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local EmuDim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// The warp's threads are not lock-stepped here: __syncwarp is a barrier of
// the 32 threads of the caller's warp (all of them must call it).
inline void __syncwarp() {
  static std::mutex lock;
  static std::barrier<>* warps[64];
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> g(lock);
    auto& w = warps[threadIdx.x / 32];
    if (w == nullptr) w = new std::barrier<>(32);
    bar = w;
  }
  bar->arrive_and_wait();
}

// A butterfly exchange of the caller's warp through a slot per lane, between
// two warp barriers (all 32 threads must call it).
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  static float slots[64][32];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  slots[w][l] = v;
  __syncwarp();
  const float r = slots[w][l ^ mask];
  __syncwarp();
  return r;
}

struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }

typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int kEmuSharedLimit = 232448;  // bytes a block may use on sm_90
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= kEmuSharedLimit ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// libcuda's entry points, as the runtime hands them out: only the
// stand-in cuTensorMapEncodeTiled of cuda.h.
#include "cuda.h"
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char* symbol, void** fn, unsigned int, unsigned long long,
    cudaDriverEntryPointQueryResult* q) {
  if (std::strcmp(symbol, "cuTensorMapEncodeTiled") != 0) {
    *q = cudaDriverEntryPointSymbolNotFound;
    return cudaErrorInvalidValue;
  }
  *fn = reinterpret_cast<void*>(&cuTensorMapEncodeTiled);
  *q = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}

inline void emu_run_grid(const std::function<void()>& body, unsigned grid,
                         int nthreads, size_t smem) {
  assert(smem <= static_cast<size_t>(kEmuSharedLimit));
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(nthreads);
    emu_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = nthreads;
        gridDim.x = grid;
        body();
        bar.arrive_and_drop();  // a thread that returned early leaves the barrier
      });
    for (auto& th : threads) th.join();
  }
}
#define DCONV_LAUNCH(kernel, grid, smem, stream, params) \
  emu_run_grid([&] { kernel(params); }, grid, dconv::kThreads, smem)
#define DCONV_LAUNCH_T(kernel, grid, threads, smem, stream, params) \
  emu_run_grid([&] { kernel(params); }, grid, threads, smem)
