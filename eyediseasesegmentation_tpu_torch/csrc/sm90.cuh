// Hopper (sm_90a) primitives: each function is a thin wrapper over one PTX
// form, taking generic pointers to shared memory. Every PTX string of the
// port's wgmma and mma.sync kernels lives here, so that a host-side
// emulation can stand in for this file (tests/torch_cuda_emulation/sm90.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- asynchronous copies ------------------------------------------------------

// TMA tiled load of the box at coordinates (c0, c1, c2, c3) of a 4-D tensor
// map into shared memory; completes the box's bytes on the barrier.
// Coordinates outside the tensor, negative ones included, read zeros. The
// first coordinate (along the contiguous dimension) must be a multiple of
// 16 bytes: the H100 faults on others (cudaErrorIllegalInstruction).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA tiled load of the box at (c0, c1, c2) of a 3-D tensor map; as above.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA tiled load of the box at (c0, c1) of a 2-D tensor map; as above.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier writes to shared memory before later
// accesses to it by the async proxy (wgmma's operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers -------------------------------------------------------------

// Waits for `count` threads (a multiple of 32) at barrier `id` (1..15).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ----------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// swizzle atoms (8 rows of 128 bytes) start 1024-byte aligned: start
// address, leading byte offset (between atoms along M or N of an MN-major
// operand), stride byte offset (between groups of 8 rows along K), layout 1
// (128-byte swizzle). Offsets in bytes, multiples of 16.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[64 x 64] = A[64 x 16] * B[16 x 64] + (accumulate ? d : 0), bf16
// operands from shared memory, fp32 sums in the warpgroup's registers.
// TA / TB = 1: A is M-major, B is N-major (the 16 K rows of each are
// 128-byte lines of 64 values). TA / TB = 0: K-major (each of the 64 rows
// of A, or columns of B, is a 128-byte line of 64 K values, of which the
// descriptor's start address picks 16: 32 bytes further per step). Thread t
// of the warpgroup holds d[16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)]
// [8 * (i / 4) + 2 * (t % 4) + i % 2] in d[i].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}


// ---- warp-level matrix products (mma.sync) ----------------------------------
// Fragments of a warp, g = lane / 4, c = lane % 4, two bf16 values a register
// (the lower index in the low half): A (16 x K, row-major) a0 = A[g][2c..],
// a1 = A[g + 8][2c..], (K = 16) a2 = A[g][2c + 8..], a3 = A[g + 8][2c + 8..];
// B (K x 8) b0 = B[2c..][g], (K = 16) b1 = B[2c + 8..][g]; D (16 x 8, fp32)
// d0, d1 = D[g][2c], D[g][2c + 1], d2, d3 = D[g + 8][2c], D[g + 8][2c + 1].

// d += A[16 x 8] * B[8 x 8], bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_m16n8k8_bf16(float (&d)[4], uint32_t a0,
                                                 uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += A[16 x 16] * B[16 x 8], bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 bf16 matrices from shared memory, transposed: lanes 0-7 give the
// 16-byte rows of the first, lanes 8-15 those of the second (the other
// lanes' addresses are not read); lane 4g + c receives rows 2c, 2c + 1 of
// column g of matrix i in r[i]. Rows 16-byte aligned.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

}  // namespace sm90
