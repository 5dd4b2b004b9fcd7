// Cost probes L3: four kernels that each run one part of K1's work
// (ntt_fused.cu), at word 32 and word 64, so that their times split K1's
// time on the card.  They replace the Pallas lab's diagnostic kernels
// (tools/pallas_lab.py, all through _diag_call :419):
//
//   diag_copy_kernel   diag_copy :444.  K1's memory path alone, at K1's
//                      design point (rounds.cuh: Fused<T>'s threads and
//                      minimum blocks an SM, exchange_bytes<T>(logn) of
//                      padded shared memory, so K1's occupancy): its first
//                      round's coalesced load into registers at stride
//                      N/16, the write of those registers into the
//                      exchange buffer, one barrier, and copy_out's
//                      coalesced 16-byte store.  No rounds, no exchanges:
//                      the floor K1's memory path can reach at its
//                      occupancy (at word 64 and N = 2^14 the 136 KB buffer
//                      allows one block an SM).
//   diag_mul_kernel    diag_mul :402.  Each thread takes its words from shared
//                      memory into registers and runs n_mults chained
//                      x * c + 1 (mod 2^32) on each 32-bit half, then stores:
//                      32-bit multiply throughput.  Each step is one
//                      mad.lo.u32 in inline PTX, with c a kernel argument, so
//                      the compiler cannot fold the chain into one multiply.
//   diag_math_kernel   diag_math :455.  Each thread takes pairs (i, i + N/2)
//                      into registers and runs n_rounds Harvey butterflies
//                      under w[1] on them: the butterfly arithmetic with no
//                      shared-memory traffic and no barriers.  Its product
//                      is a reduction policy of modarith.cuh: ShoupRed, or
//                      SolinasRed under the NTT_MULMOD=solinas switch
//                      (ntt_diag_math_solinas_u*, (e, k) before the
//                      stream, no w_con read), as the Pallas probe's
//                      ops.fwd_bfly takes the Solinas product there.
//   diag_moves         diag_moves :479.  K1 itself, rounds_kernel<T, ...,
//                      Swaps> (rounds.cuh), with the movement-only policy
//                      in place of the reduction policy: K1's load, its
//                      rounds with each butterfly a swap of its pair (no
//                      twiddle read), its exchanges and barriers, and its
//                      store.  Each stage flips one bit of the index: the
//                      result is the polynomial reversed.  The Pallas probe
//                      also moves the data through both transposes; K1 has
//                      none, so neither has this.  It follows any later
//                      redesign of K1's rounds by construction.
//
// diag_copy and diag_moves run K1's design point, so at the same shape
// diag_copy is K1's memory path, diag_moves - diag_copy its exchanges and
// barriers, and K1 - diag_moves what its butterflies and twiddle loads add.
// diag_mul and diag_math keep K1's first geometry (poly_block.cuh: one block
// per polynomial, min(N/2, 1024) threads, the polynomial loaded once into
// dynamic shared memory and stored once).
//
// What bounds them: copy and moves move 2 x N words through device memory a
// polynomial and do no arithmetic (bytes); mul does 42 x word/32 32-bit
// multiplies a word, about as long as its bytes at word 64; math does
// n_rounds x N/2 butterflies.  None is tuned: each is K1's own
// structure with the other parts taken out.
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "poly_block.cuh"
#include "rounds.cuh"

namespace ntt {
namespace {

// K1's first round without its stages: each group's R = 2^K words from
// device memory into registers (stride N / R) and into the exchange buffer,
// one barrier, then copy_out.
template <typename T, int K>
__device__ __forceinline__ void copy_path(const T* __restrict__ gin, T* __restrict__ gout,
                                          T* sm, int logn, bool vec) {
  run_round<T, K, false>(gin, nullptr, sm, nullptr, nullptr, (T)0, Swaps(), FinalConsts<T>(),
                         logn, 0, 0, vec);
  __syncthreads();
  copy_out<T>(gout, sm, 1 << logn, false, (T)0, vec);
}

template <typename T, int K, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
diag_copy_kernel(const T* __restrict__ in, T* __restrict__ out, int logn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const T* gin = in + ((size_t)blockIdx.x << logn);
  T* gout = out + ((size_t)blockIdx.x << logn);
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  switch (logn < K ? logn : K) {
    case 1: copy_path<T, 1>(gin, gout, sm, logn, vec); break;
    case 2: copy_path<T, kMin<K, 2>>(gin, gout, sm, logn, vec); break;
    case 3: copy_path<T, kMin<K, 3>>(gin, gout, sm, logn, vec); break;
    default: copy_path<T, K>(gin, gout, sm, logn, vec); break;
  }
}

template <typename T>
int launch_copy(const void* in, void* out, int batch, int logn, void* stream) {
  typedef Fused<T> F;
  return launch_fused<T>(diag_copy_kernel<T, F::kLogR, F::kThreads, F::kMinBlocks>, batch, logn,
                         exchange_bytes<T>(logn), stream, (const T*)in, (T*)out, logn);
}

template <typename T>
int launch_moves(const void* in, void* out, int batch, int logn, void* stream) {
  return launch_rounds<T, false>(in, out, nullptr, nullptr, 0, FinalConsts<T>(), batch, logn,
                                 0, stream, Swaps());
}

__device__ __forceinline__ u32 mad_step(u32 x, u32 c) {
#if defined(__CUDA_ARCH__)
  u32 r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(c), "r"(1u));
  return r;
#else
  return x * c + 1u;
#endif
}

__device__ __forceinline__ u32 mad_word(u32 x, u32 c, int n_mults) {
  for (int k = 0; k < n_mults; ++k) x = mad_step(x, c);
  return x;
}

__device__ __forceinline__ u64 mad_word(u64 x, u32 c, int n_mults) {
  const u32 lo = mad_word((u32)x, c, n_mults);
  const u32 hi = mad_word((u32)(x >> 32), c, n_mults);
  return ((u64)hi << 32) | lo;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
diag_mul_kernel(const T* __restrict__ in, T* __restrict__ out, u32 c, int n_mults,
                int logn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const size_t base = (size_t)blockIdx.x << logn;
  load_poly<T>(a, in + base, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = mad_word(a[i], c, n_mults);
}

template <typename T, class Red>
__global__ void __launch_bounds__(kMaxThreads)
diag_math_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                 const T* __restrict__ w_con, T q, int n_rounds, int logn, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t base = (size_t)blockIdx.x << logn;
  load_poly<T>(a, in + base, n);
  const T w1 = __ldg(w + 1), wc1 = Red::kCon ? __ldg(w_con + 1) : (T)0;
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    T x = a[j];
    T y = a[j + half];
    for (int r = 0; r < n_rounds; ++r) fwd_bfly<T, Red>(x, y, w1, wc1, q, red);
    out[base + j] = x;
    out[base + j + half] = y;
  }
}

}  // namespace
}  // namespace ntt

// Plain C interface, loaded with ctypes by ntt_tpu_torch/native.py: one launch
// of batch blocks on `stream`, N = 2^logn; returns the cudaError_t of the
// launch.
extern "C" {

#define NTT_PROBES(W, T)                                                              \
  int ntt_diag_copy_u##W(const void* in, void* out, int batch, int logn,             \
                         void* stream) {                                              \
    return ntt::launch_copy<T>(in, out, batch, logn, stream);                         \
  }                                                                                   \
  int ntt_diag_mul_u##W(const void* in, void* out, unsigned long long c, int n_mults, \
                        int batch, int logn, void* stream) {                          \
    return ntt::launch_per_poly<T>(ntt::diag_mul_kernel<T>, batch, logn, stream,      \
                                   (const T*)in, (T*)out, (ntt::u32)c, n_mults, logn);  \
  }                                                                                   \
  int ntt_diag_math_u##W(const void* in, void* out, const void* w, const void* w_con, \
                         unsigned long long q, int n_rounds, int batch, int logn,     \
                         void* stream) {                                              \
    return ntt::launch_per_poly<T>(ntt::diag_math_kernel<T, ntt::ShoupRed>, batch,    \
                                   logn, stream, (const T*)in, (T*)out, (const T*)w,  \
                                   (const T*)w_con, (T)q, n_rounds, logn,             \
                                   ntt::ShoupRed());                                  \
  }                                                                                   \
  int ntt_diag_math_solinas_u##W(const void* in, void* out, const void* w,           \
                                 const void* w_con, unsigned long long q,            \
                                 int n_rounds, int batch, int logn, int e, int k,    \
                                 void* stream) {                                      \
    return ntt::launch_per_poly<T>(ntt::diag_math_kernel<T, ntt::SolinasRed>, batch,  \
                                   logn, stream, (const T*)in, (T*)out, (const T*)w,  \
                                   (const T*)w_con, (T)q, n_rounds, logn,             \
                                   ntt::SolinasRed{e, k});                            \
  }                                                                                   \
  int ntt_diag_moves_u##W(const void* in, void* out, int batch, int logn,            \
                          void* stream) {                                             \
    return ntt::launch_moves<T>(in, out, batch, logn, stream);                        \
  }

NTT_PROBES(32, ntt::u32)
NTT_PROBES(64, ntt::u64)

}  // extern "C"
