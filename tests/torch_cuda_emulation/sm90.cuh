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
//     leading and stride byte offsets, layout) with the swizzle undone, so a
//     wrong descriptor or a misplaced operand gives wrong sums. Each thread
//     computes its own 32 accumulators, at the positions the hardware gives
//     it. Shared-memory addresses are offsets into dconv::smem.
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

namespace dconv {
extern unsigned char smem[];
}

namespace sm90 {

inline std::mutex emu_bar_lock;
inline std::condition_variable emu_bar_cv;

// The 8 bytes of an mbarrier: expected and pending arrivals, phase.
struct EmuBarState {
  uint16_t expected, pending, phase;
  int16_t pad;
};

inline uint32_t smem_offset(const void* p) {
  const auto off = static_cast<const unsigned char*>(p) - dconv::smem;
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

// The 128-byte swizzle of a shared-memory offset (dconv::smem is 1024-byte
// aligned, so offsets carry the address bits the hardware swizzles on).
inline uint32_t swz128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2, int c3) {
  EmuTensorMap m;
  std::memcpy(&m, map, sizeof(m));
  assert(m.rank == 4);
  const uint32_t d0 = smem_offset(dst);
  assert(d0 % (m.swizzle128 ? 1024 : 128) == 0);
  const int c[4] = {c0, c1, c2, c3};
  // the H100 faults (illegal instruction) on a box whose first coordinate
  // along the contiguous dimension is not a multiple of 16 bytes
  assert((static_cast<long long>(c0) * m.elem) % 16 == 0);
  const uint32_t n = m.box[0] * m.box[1] * m.box[2] * m.box[3];
  for (uint32_t e = 0; e < n; ++e) {
    uint32_t rest = e;
    bool inside = true;
    uint64_t src = 0;
    for (int i = 0; i < 4; ++i) {
      const long long g = c[i] + static_cast<long long>(rest % m.box[i]);
      rest /= m.box[i];
      inside = inside && g >= 0 && g < static_cast<long long>(m.dims[i]);
      if (inside) src += static_cast<uint64_t>(g) * m.strides[i];
    }
    uint32_t off = d0 + e * m.elem;
    if (m.swizzle128) off = swz128(off);
    if (inside)
      std::memcpy(dconv::smem + off, m.base + src, m.elem);
    else
      std::memset(dconv::smem + off, 0, m.elem);
  }
  emu_complete_tx(bar, n * m.elem);
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

// Element (mn, k) of an MN-major bf16 operand with the 128-byte swizzle:
// 64 values of M (or N) per 128-byte line, K lines 128 bytes apart in groups
// of 8, groups `sbo` apart, atoms of 64 along MN `lbo` apart.
inline float emu_operand_mn(uint64_t desc, int mn, int k) {
  assert((desc >> 62) == 1 && ((desc >> 49) & 7) == 0);
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const uint32_t off = start + (mn / 64) * lbo + (k / 8) * sbo +
                       (k % 8) * 128 + (mn % 64) * 2;
  __nv_bfloat16 v;
  std::memcpy(&v, dconv::smem + swz128(off), 2);
  return __bfloat162float(v);
}

template <int TA, int TB>
inline void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                 int accumulate) {
  static_assert(TA == 1 && TB == 1, "the stand-in reads MN-major operands");
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int i = 0; i < 32; ++i) {
    const int m = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += emu_operand_mn(da, m, k) * emu_operand_mn(db, n, k);
    d[i] = accumulate ? d[i] + s : s;
  }
}

}  // namespace sm90
