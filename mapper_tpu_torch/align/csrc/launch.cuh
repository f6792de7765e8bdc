// The launch the scorers and the device-candidates kernels go through, with
// the shared memory opt-in above 48 KB.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace cuda_launch {

// Dynamic shared memory a block takes without opting in, and after (sm_90).
constexpr size_t kSmemDefault = 48 * 1024;
constexpr int kSmemOptIn = 232448;

// Launches `kernel` on `grid` blocks of `block` threads with `smem` bytes of
// dynamic shared memory; above 48 KB the kernel opts in first, to the card's
// most (kernels.py's _SMEM_LIMIT bounds `smem`).  Returns the opt-in's or
// the launch's CUDA error.  A kernel that opts in declares no static shared
// memory: the card's most is for both together.
template <class... Params, class... Args>
int launch_kernel(void (*kernel)(Params...), unsigned grid, unsigned block, size_t smem,
                  void* stream, Args... args) {
  if (smem > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_launch
