// The geometry of the lab's kernels L1 / L2 (ntt_lab.cu) and of the L3 probes
// (probes.cu): one block per polynomial of N = 2^logn words, min(N/2, 1024)
// threads (one butterfly each per step, strided beyond 2048 words), the
// polynomial in dynamic shared memory.  It was K1's geometry until K1 / K2
// moved to register rounds (rounds.cuh); the probes keep measuring this one,
// whose K1 structure lives on as L1 at one stage a round (v2-r2).  The launch
// helper launch_blocks is shared by every kernel that takes one block per
// polynomial, K1 / K2 included.
#pragma once

#include <cuda_runtime.h>

namespace ntt {

constexpr int kMaxThreads = 1024;

inline int block_threads(int logn) {
  const int half = 1 << (logn - 1);
  return half < kMaxThreads ? half : kMaxThreads;
}

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

// Launch `kernel` over `batch` polynomials of N = 2^logn words of T at this
// geometry, with the polynomial's bytes of dynamic shared memory.
template <typename T, typename... Params, typename... Args>
int launch_per_poly(void (*kernel)(Params...), int batch, int logn, void* stream,
                    Args... args) {
  if (batch < 1 || logn < 1 || logn > 24) return (int)cudaErrorInvalidValue;
  return launch_blocks(kernel, batch, block_threads(logn), sizeof(T) << logn, stream,
                       args...);
}

// Device side: the block's polynomial in shared memory.
template <typename T>
__device__ __forceinline__ void load_poly(T* a, const T* __restrict__ in, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = in[i];
  __syncthreads();
}

}  // namespace ntt
