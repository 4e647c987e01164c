// K1's sm90 kernel (csrc/axial_sm90.cuh) compiled for the host against the
// stand-in headers of this directory (see
// tests/test_torch_axial_emulation.py): one std::thread per CUDA thread,
// blocks one after another.
#include "cuda_runtime.h"
namespace k1 {
alignas(1024) unsigned char smem[256 * 1024];  // the kernel's `extern __shared__`
}
unsigned char* emu_smem() { return k1::smem; }
// The dynamic shared memory of the last launch, for the test to hold the
// wrapper's plan (ops/axial_attention.py `sm90_smem`) to the kernel's.
static size_t emu_launch_smem = 0;
extern "C" long long emu_last_smem() {
  return static_cast<long long>(emu_launch_smem);
}
#define K1_LAUNCH(kernel, grid, threads, smem, stream, params) \
  (emu_launch_smem = (smem),                                   \
   emu_run_grid([&] { kernel(params); }, grid, threads, smem))
#define K1_ARRANGE_BLOCKS 1
#include "axial_sm90.cuh"
