// K3: element-wise (a * b) mod q, strict output, at word 32 and word 64 --
// the NTT-domain product of a negacyclic polynomial multiply.
//
// In the JAX package this step is XLA code, not Pallas (api._jit_pointwise
// over ntt_tpu.modmath.mul_mod_q32 / mul_mod_q), and XLA fuses it.  Nothing
// fuses it on the PyTorch side: as plain tensor code it would be some twenty
// passes over device memory, so it is a kernel here.
//
// What bounds it on an H100: device memory.  Each element moves three words
// (two loads, one store) for about a dozen integer multiplies, far below the
// card's ratio of operations to bytes.  Design: one thread per element in a
// grid-stride loop, neighbouring threads on neighbouring words so that every
// warp access is coalesced; the per-q constants are computed once on the host
// and passed by value.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace ntt {

constexpr int kPointwiseThreads = 256;

template <typename T, typename K>
__global__ void __launch_bounds__(kPointwiseThreads)
mul_mod_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
               long long count, K k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    out[i] = mul_mod(a[i], b[i], k);
  }
}

template <typename T, typename K>
int launch_mul_mod(const void* a, const void* b, void* out, long long count, const K& k,
                   void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (count + kPointwiseThreads - 1) / kPointwiseThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  mul_mod_kernel<T, K><<<(unsigned)blocks, kPointwiseThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)out, count, k);
  return (int)cudaGetLastError();
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu).  q < 2^30 for the u32 entry point and
// q < 2^62 for the u64 one; the caller checks both.
extern "C" {

int ntt_mul_mod_u32(const void* a, const void* b, void* out, long long count,
                    unsigned long long q, void* stream) {
  ntt::MulModConsts32 k;
  k.q = (ntt::u32)q;
  k.c = (ntt::u32)((1ull << 32) % q);
  k.c_con = (ntt::u32)(((ntt::u64)k.c << 32) / q);
  k.mu = (ntt::u32)((1ull << 32) / q);
  return ntt::launch_mul_mod<ntt::u32>(a, b, out, count, k, stream);
}

int ntt_mul_mod_u64(const void* a, const void* b, void* out, long long count,
                    unsigned long long q, void* stream) {
  ntt::MulModConsts64 k;
  k.q = q;
  k.c[0] = k.c_con[0] = 0;
  for (int i = 1; i < 4; ++i) {
    const unsigned __int128 c = ((unsigned __int128)1 << (32 * i)) % q;
    k.c[i] = (ntt::u64)c;
    k.c_con[i] = (ntt::u64)((c << 64) / q);
  }
  k.mu = (1ull << 32) / q;
  return ntt::launch_mul_mod<ntt::u64>(a, b, out, count, k, stream);
}

}  // extern "C"
