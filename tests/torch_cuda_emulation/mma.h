// Host stand-in for <mma.h>: a 16x16x16 wmma fragment is a whole tile held
// by lane 0 of the warp, which alone loads, multiplies and stores. The
// loads and stores assert wmma's alignment rules (32-byte pointers, leading
// dimensions that are multiples of 16 bytes).
#pragma once
#include "cuda_bf16.h"
#include "cuda_runtime.h"
namespace nvcuda {
namespace wmma {
struct matrix_a; struct matrix_b; struct accumulator; struct row_major; struct col_major;
enum layout_t { mem_row_major, mem_col_major };
template <typename Use, int M, int N, int K, typename T, typename L = void>
struct fragment { float x[256]; };
inline bool lead() { return threadIdx.x % 32 == 0; }
template <typename F>
void fill_fragment(F& f, float v) { if (lead()) for (auto& e : f.x) e = v; }
template <typename F>
void load_matrix_sync(F& f, const __nv_bfloat16* p, unsigned ld) {
  assert(reinterpret_cast<uintptr_t>(p) % 32 == 0 && ld % 8 == 0);
  if (lead())
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 16; ++c) f.x[r * 16 + c] = __bfloat162float(p[r * ld + c]);
}
template <typename D, typename A, typename B, typename C>
void mma_sync(D& d, const A& a, const B& b, const C& c) {
  if (!lead()) return;
  float out[256];
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 16; ++n) {
      float s = c.x[r * 16 + n];
      for (int k = 0; k < 16; ++k) s += a.x[r * 16 + k] * b.x[k * 16 + n];
      out[r * 16 + n] = s;
    }
  for (int i = 0; i < 256; ++i) d.x[i] = out[i];
}
template <typename F>
void store_matrix_sync(float* p, const F& f, unsigned ld, layout_t layout) {
  assert(reinterpret_cast<uintptr_t>(p) % 32 == 0 && ld % 4 == 0);
  if (!lead()) return;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      p[layout == mem_col_major ? r + c * ld : r * ld + c] = f.x[r * 16 + c];
}
}  // namespace wmma
}  // namespace nvcuda
