// Host stand-in for csrc/sm90.cuh, for rehearsing the wgmma kernels without
// a GPU (one std::thread per CUDA thread, see cuda_runtime.h):
//   - an mbarrier is its 8 bytes of shared memory (pending arrivals, phase,
//     transaction bytes), changed under one lock; waits sleep on a
//     condition variable;
//   - the TMA load copies the box from host memory, element by element with
//     zero fill outside the tensor (negative coordinates included), and
//     applies the 128-byte swizzle to the shared-memory address; like the
//     H100, it refuses a box whose first element along the contiguous
//     dimension is not 16-byte aligned; the bulk copy is a memcpy; both complete their
//     bytes on the barrier;
//   - wgmma reads A and B back through their descriptors (start address,
//     leading and stride byte offsets, layout; MN-major or K-major) with the
//     swizzle undone, so a wrong descriptor or a misplaced operand gives
//     wrong sums. Each thread computes its own 32 accumulators, at the
//     positions the hardware gives it;
//   - mma.sync and ldmatrix exchange the warp's registers (or row
//     addresses) through a slot per lane between two warp barriers, and each
//     lane computes (or picks) its own part at the positions of the PTX
//     fragment layouts.
// Shared-memory addresses are offsets into emu_smem(), the `extern
// __shared__` array of the library's kernels, which the including file
// defines.
#pragma once
#include <barrier>
#include <cassert>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>

#include "cuda.h"
#include "cuda_bf16.h"
#include "cuda_runtime.h"

// The base of the kernels' dynamic shared memory (1024-byte aligned).
unsigned char* emu_smem();

namespace sm90 {

inline std::mutex emu_bar_lock;
inline std::condition_variable emu_bar_cv;

// The 8 bytes of an mbarrier: expected and pending arrivals, phase.
struct EmuBarState {
  uint16_t expected, pending, phase;
  int16_t pad;
};

inline uint32_t smem_offset(const void* p) {
  const auto off = static_cast<const unsigned char*>(p) - emu_smem();
  assert(off >= 0 && off < 256 * 1024);
  return static_cast<uint32_t>(off);
}

// The barrier's transaction count lives in a side table keyed by address
// (the 8 bytes hold arrivals and phase).
inline int32_t emu_tx[256 * 1024 / 8];

inline void emu_complete(uint64_t* bar) {  // lock held
  auto* st = reinterpret_cast<EmuBarState*>(bar);
  if (st->pending == 0 && emu_tx[smem_offset(bar) / 8] == 0) {
    st->phase ^= 1;
    st->pending = st->expected;
    emu_bar_cv.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> g(emu_bar_lock);
  assert(reinterpret_cast<uintptr_t>(bar) % 8 == 0 && count > 0);
  auto* st = reinterpret_cast<EmuBarState*>(bar);
  st->expected = st->pending = static_cast<uint16_t>(count);
  st->phase = 0;
  emu_tx[smem_offset(bar) / 8] = 0;
}
inline void mbar_fence_init() {}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(emu_bar_lock);
  auto* st = reinterpret_cast<EmuBarState*>(bar);
  assert(st->pending > 0);
  --st->pending;
  emu_complete(bar);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(emu_bar_lock);
  emu_tx[smem_offset(bar) / 8] += static_cast<int32_t>(bytes);
  auto* st = reinterpret_cast<EmuBarState*>(bar);
  assert(st->pending > 0);
  --st->pending;
  emu_complete(bar);
}
inline void emu_complete_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(emu_bar_lock);
  emu_tx[smem_offset(bar) / 8] -= static_cast<int32_t>(bytes);
  emu_complete(bar);
}
// Blocks for a while, as the hardware's try_wait does, until the phase of
// parity `parity` has completed.
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> g(emu_bar_lock);
  auto* st = reinterpret_cast<EmuBarState*>(bar);
  return emu_bar_cv.wait_for(g, std::chrono::milliseconds(10),
                             [&] { return st->phase != parity; });
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The 128-byte swizzle of a shared-memory offset (emu_smem() is 1024-byte
// aligned, so offsets carry the address bits the hardware swizzles on).
inline uint32_t swz128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

inline void emu_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                         const int* c, uint32_t rank) {
  EmuTensorMap m;
  std::memcpy(&m, map, sizeof(m));
  assert(m.rank == rank);
  const uint32_t d0 = smem_offset(dst);
  assert(d0 % (m.swizzle128 ? 1024 : 128) == 0);
  // the H100 faults (illegal instruction) on a box whose first coordinate
  // along the contiguous dimension is not a multiple of 16 bytes
  assert((static_cast<long long>(c[0]) * m.elem) % 16 == 0);
  uint32_t n = 1;
  for (uint32_t i = 0; i < rank; ++i) n *= m.box[i];
  for (uint32_t e = 0; e < n; ++e) {
    uint32_t rest = e;
    bool inside = true;
    uint64_t src = 0;
    for (uint32_t i = 0; i < rank; ++i) {
      const long long g = c[i] + static_cast<long long>(rest % m.box[i]);
      rest /= m.box[i];
      inside = inside && g >= 0 && g < static_cast<long long>(m.dims[i]);
      if (inside) src += static_cast<uint64_t>(g) * m.strides[i];
    }
    uint32_t off = d0 + e * m.elem;
    if (m.swizzle128) off = swz128(off);
    if (inside)
      std::memcpy(emu_smem() + off, m.base + src, m.elem);
    else
      std::memset(emu_smem() + off, 0, m.elem);
  }
  emu_complete_tx(bar, n * m.elem);
}

inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  emu_tma_load(dst, map, bar, c, 4);
}
inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  const int c[3] = {c0, c1, c2};
  emu_tma_load(dst, map, bar, c, 3);
}
inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1) {
  const int c[2] = {c0, c1};
  emu_tma_load(dst, map, bar, c, 2);
}

inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  assert(bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(src) % 16 == 0);
  std::memcpy(dst, src, bytes);
  emu_complete_tx(bar, bytes);
}

inline void fence_proxy_async() {}

inline std::mutex emu_named_lock;
inline std::barrier<>* emu_named[16];
inline int emu_named_count[16];
inline void bar_sync(int id, int count) {
  assert(id > 0 && id < 16 && count % 32 == 0);
  {
    std::lock_guard<std::mutex> g(emu_named_lock);
    if (emu_named[id] == nullptr) {
      emu_named[id] = new std::barrier<>(count);
      emu_named_count[id] = count;
    }
    assert(emu_named_count[id] == count);
  }
  emu_named[id]->arrive_and_wait();
}

// A wgmma is one operation of the whole warpgroup: once wait_group returns,
// its reads of shared memory are over for all 128 threads. The stand-in's
// threads compute their parts one by one, so the wait is a barrier of the
// warpgroup.
inline std::barrier<>* emu_wg_barrier(int wg) {
  static std::mutex lock;
  static std::barrier<>* bars[8];
  std::lock_guard<std::mutex> g(lock);
  if (bars[wg] == nullptr) bars[wg] = new std::barrier<>(128);
  return bars[wg];
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {
  emu_wg_barrier(threadIdx.x / 128)->arrive_and_wait();
}

inline uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  assert(lbo % 16 == 0 && sbo % 16 == 0);
  return static_cast<uint64_t>(smem_offset(p) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Element (mn, k) of a bf16 operand with the 128-byte swizzle. MN-major:
// 64 values of M (or N) per 128-byte line, K lines 128 bytes apart in groups
// of 8, groups `sbo` apart, atoms of 64 along MN `lbo` apart. K-major: each
// row of M (or N) a 128-byte line from the start address on (16 K values of
// its 64), rows in groups of 8 `sbo` apart.
inline float emu_operand(uint64_t desc, int mn, int k, bool mn_major) {
  assert((desc >> 62) == 1 && ((desc >> 49) & 7) == 0);
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const uint32_t off =
      mn_major ? start + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 +
                     (mn % 64) * 2
               : start + (mn / 8) * sbo + (mn % 8) * 128 + k * 2;
  if (!mn_major) assert((start % 128) + 32 <= 128);  // within the line
  __nv_bfloat16 v;
  std::memcpy(&v, emu_smem() + swz128(off), 2);
  return __bfloat162float(v);
}

template <int TA, int TB>
inline void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                 int accumulate) {
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int i = 0; i < 32; ++i) {
    const int m = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += emu_operand(da, m, k, TA == 1) * emu_operand(db, n, k, TB == 1);
    d[i] = accumulate ? d[i] + s : s;
  }
}

// ---- mma.sync and ldmatrix -------------------------------------------------

inline uint32_t emu_warp_regs[64][32][6];
inline const void* emu_warp_rows[64][32];

inline float emu_bf16_half(uint32_t w, int half) {
  return __uint_as_float(half ? (w & 0xFFFF0000u) : (w << 16));
}

// d += A[16 x K] * B[K x 8] from the warp's fragments (K = 8 or 16): A(r, k)
// is half k % 2 of register r / 8 + 2 (k / 8) of lane 4 (r % 8) + (k % 8) / 2,
// B(k, n) half k % 2 of register k / 8 of lane 4 n + (k % 8) / 2.
template <int K>
inline void emu_mma(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  auto& slot = emu_warp_regs[w];
  for (int i = 0; i < K / 4; ++i) slot[l][i] = a[i];
  for (int i = 0; i < K / 8; ++i) slot[l][4 + i] = b[i];
  __syncwarp();
  const int g = l / 4, c = l % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * c + (e & 1);
    float s = 0.f;
    for (int k = 0; k < K; ++k)
      s += emu_bf16_half(slot[4 * (r % 8) + (k % 8) / 2][r / 8 + 2 * (k / 8)],
                         k % 2) *
           emu_bf16_half(slot[4 * n + (k % 8) / 2][4 + k / 8], k % 2);
    out[e] = d[e] + s;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline void mma_m16n8k8_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                             uint32_t b0) {
  const uint32_t a[2] = {a0, a1}, b[1] = {b0};
  emu_mma<8>(d, a, b);
}
inline void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                              uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  emu_mma<16>(d, a, b);
}

inline void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (l < 16) {
    smem_offset(row);
    assert(reinterpret_cast<uintptr_t>(row) % 16 == 0);
  }
  emu_warp_rows[w][l] = row;
  __syncwarp();
  const int g = l / 4, c = l % 4;
  for (int i = 0; i < 2; ++i) {
    uint16_t lo, hi;
    std::memcpy(&lo, static_cast<const uint16_t*>(emu_warp_rows[w][8 * i + 2 * c]) + g, 2);
    std::memcpy(&hi, static_cast<const uint16_t*>(emu_warp_rows[w][8 * i + 2 * c + 1]) + g, 2);
    r[i] = lo | (static_cast<uint32_t>(hi) << 16);
  }
  __syncwarp();
}

}  // namespace sm90
