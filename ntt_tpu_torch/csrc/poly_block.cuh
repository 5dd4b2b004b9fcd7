// launch_blocks: the one launch line of the port's block kernels, with the
// kernel's dynamic shared memory allowed first.  rounds.cuh's launch_fused
// (K1 / K2, the lab's L1 / L2 and all four L3 probes at K1's design point)
// and ntt_sixstep.cu's launchers (K4-K7 on tiles) call it.  The file once
// also held K1's first geometry (one block per polynomial, min(N/2, 1024)
// threads, the polynomial in shared memory), which every kernel has left.
#pragma once

#include <cuda_runtime.h>

namespace ntt {

// Launch `kernel` as `batch` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory; the cudaError_t of the launch, nonzero when it never
// ran.
template <typename... Params, typename... Args>
int launch_blocks(void (*kernel)(Params...), int batch, int threads, size_t smem,
                  void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace ntt
