// K1's geometry, shared by every kernel that holds one polynomial in one
// block's shared memory: K1 / K2 (ntt_fused.cu), the lab's L1 / L2
// (ntt_lab.cu) and the L3 probes (probes.cu), so that their times compare.
// One block per polynomial of N = 2^logn words, min(N/2, 1024) threads (one
// butterfly each per step, strided beyond 2048 words), the polynomial in
// dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

namespace ntt {

constexpr int kMaxThreads = 1024;

inline int block_threads(int logn) {
  const int half = 1 << (logn - 1);
  return half < kMaxThreads ? half : kMaxThreads;
}

// Launch `kernel` over `batch` polynomials of N = 2^logn words of T, with the
// polynomial's bytes of dynamic shared memory; the cudaError_t of the launch,
// nonzero when it never ran.
template <typename T, typename... Params, typename... Args>
int launch_per_poly(void (*kernel)(Params...), int batch, int logn, void* stream,
                    Args... args) {
  if (batch < 1 || logn < 1 || logn > 24) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) << logn;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, block_threads(logn), smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Device side: the block's polynomial in shared memory.
template <typename T>
__device__ __forceinline__ void load_poly(T* a, const T* __restrict__ in, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = in[i];
  __syncthreads();
}

}  // namespace ntt
