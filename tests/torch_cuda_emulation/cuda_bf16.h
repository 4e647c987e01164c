// Host stand-in for <cuda_bf16.h>: bfloat16 as its 16 bits, round to nearest
// even.
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t(0x7fc0)};
  return {uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline __nv_bfloat16 __hmul(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) * __bfloat162float(b));
}
inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__hmul(a.x, b.x), __hmul(a.y, b.y)};
}
