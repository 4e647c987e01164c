// Host stand-in for <cuda.h>: libcuda's tensor-map types and constants,
// and cuTensorMapEncodeTiled, which checks what libcuda checks of a tiled
// map and keeps the map's shape for the stand-in TMA of sm90.cuh.
#pragma once
#include <cstdint>
#include <cstring>

typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1;
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };

// What the stand-in keeps in a CUtensorMap.
struct EmuTensorMap {
  const unsigned char* base;
  uint32_t rank, elem, swizzle128;
  uint64_t dims[5], strides[5];  // strides in bytes; strides[0] = elem
  uint32_t box[5];
};
static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap), "fits the map");

inline CUresult cuTensorMapEncodeTiled(
    CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* elem_strides, CUtensorMapInterleave, CUtensorMapSwizzle swz,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 1 || rank > 5 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return CUDA_ERROR_INVALID_VALUE;
  EmuTensorMap m{};
  m.base = static_cast<const unsigned char*>(base);
  m.rank = rank;
  m.elem = 2;
  m.swizzle128 = swz == CU_TENSOR_MAP_SWIZZLE_128B;
  m.strides[0] = m.elem;
  for (uint32_t i = 0; i < rank; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256 || elem_strides[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16 != 0 || strides[i - 1] >= (uint64_t(1) << 40))
        return CUDA_ERROR_INVALID_VALUE;
      m.strides[i] = strides[i - 1];
    }
  }
  if ((box[0] * m.elem) % 16 != 0 || (m.swizzle128 && box[0] * m.elem > 128))
    return CUDA_ERROR_INVALID_VALUE;
  std::memset(map, 0, sizeof(*map));
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}
