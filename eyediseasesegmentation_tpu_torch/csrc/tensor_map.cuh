// Host side of the TMA: the tensor-map encoder of libcuda, shared by the
// sm90 kernels (conv_sm90.cuh, axial_sm90.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace sm90 {

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

}  // namespace sm90
