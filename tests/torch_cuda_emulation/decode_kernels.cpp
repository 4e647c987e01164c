// The decode-node CUDA sources compiled for the host against the stand-in
// headers of this directory (see tests/test_torch_kernel_emulation.py).
#include "cuda_runtime.h"
namespace dconv {
alignas(1024) unsigned char smem[256 * 1024];  // the kernels' `extern __shared__`
}
unsigned char* emu_smem() { return dconv::smem; }
#include "conv3x3.cu"
#include "scse_conv.cu"
#include "decode_pair.cu"
