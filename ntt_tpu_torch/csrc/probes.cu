// Cost probes L3: four kernels that each run one part of K1's work
// (ntt_fused.cu), at word 32 and word 64, so that their times split K1's
// time on the card.  They replace the Pallas lab's diagnostic kernels
// (tools/pallas_lab.py, all through _diag_call :419).  All four run K1's
// design point (rounds.cuh: Fused<T>'s 512 threads at most, one thread a
// group of 16 words, launch_fused) and take the first round's coalesced
// load: group (0, lo) of the round from s0 = 0 holds the words lo + i N/16
// (lo < N/16), so registers i and i + 8 lie N/2 apart.
//
//   diag_copy_kernel   diag_copy :444.  K1's memory path alone, at K1's
//                      occupancy (exchange_bytes<T>(logn) of padded shared
//                      memory and Fused<T>'s minimum blocks an SM): the
//                      first round's load into registers at stride N/16,
//                      the write of those registers into the exchange
//                      buffer, one barrier, and copy_out's coalesced
//                      16-byte store.  No rounds, no exchanges: the floor
//                      K1's memory path can reach at its occupancy (at
//                      word 64 and N = 2^14 the 136 KB buffer allows one
//                      block an SM).
//   diag_math_kernel   diag_math :455.  diag_copy's path with n_rounds
//                      Harvey butterflies of each register pair (i, i + 8),
//                      which is (j, j + N/2), under w[1] inserted between
//                      the load and the write into the exchange buffer:
//                      K1's butterfly count (m rounds of N/2) on K1's memory
//                      path, with no twiddle load beyond w[1] (and its Shoup
//                      constant, read once a thread) and no exchange.  The
//                      round loop is not unrolled, its 8 independent
//                      butterflies are.  Its product is a reduction policy
//                      of modarith.cuh: ShoupRed, or SolinasRed under the
//                      NTT_MULMOD=solinas switch (ntt_diag_math_solinas_u*,
//                      (e, k) before the stream, no w_con read), as the
//                      Pallas probe's ops.fwd_bfly takes the Solinas
//                      product there.
//   diag_mul_kernel    diag_mul :402.  The first round's load into
//                      registers, n_mults steps x * c + 1 (mod 2^32) on each
//                      32-bit half of the thread's 16 words, and a store
//                      straight from registers at the same stride (a warp
//                      stores 32 consecutive words an instruction): 32-bit
//                      multiply throughput.  The step loop is outside and
//                      the loop over the 16 / 32 halves inside, so each step
//                      issues 16 (word 32) / 32 (word 64) independent
//                      mad.lo.u32, in inline PTX with c a kernel argument
//                      so that no chain folds into one multiply.  No shared
//                      memory and no barrier: registers alone set the
//                      blocks an SM (at least kMulMinBlocks).  On an H100
//                      the step loop runs at the card's 32-bit multiply
//                      rate; what the probe takes beyond its multiplies is
//                      the part of its loads and stores they do not hide,
//                      and one block an SM ran as fast as two.
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
// At the same shape diag_copy is K1's memory path, diag_math - diag_copy
// what K1's butterflies add to it, diag_moves - diag_copy K1's exchanges and
// barriers, and K1 - diag_moves - (diag_math - diag_copy) what its twiddle
// loads add (lab.k1_split).  Each is what K1 pays beyond the part before it,
// since warps overlap one part with another, not a time of its own.
//
// What bounds them: copy and moves move 2 x N words through device memory a
// polynomial and do no arithmetic (bytes); mul does 42 x word/32 32-bit
// multiplies a word, about as long as its bytes at word 64; math moves
// copy's bytes and issues n_rounds x N/2 butterflies (29 SASS instructions
// at word 64, 9 at word 32, python -m ntt_tpu_torch.sass).  None is tuned:
// each is K1's own structure with the other parts taken out.
#include <cuda_runtime.h>

#include "modarith.cuh"
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

// The least blocks an SM diag_mul_kernel is compiled for: 64 registers a
// thread at 512 threads, room for a word-64 thread's 32 halves.
constexpr int kMulMinBlocks = 2;

__device__ __forceinline__ u32 mad_step(u32 x, u32 c) {
#if defined(__CUDA_ARCH__)
  u32 r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(c), "r"(1u));
  return r;
#else
  return x * c + 1u;
#endif
}

// One step on each 32-bit half of a word.
__device__ __forceinline__ u32 mad_word(u32 x, u32 c) { return mad_step(x, c); }
__device__ __forceinline__ u64 mad_word(u64 x, u32 c) {
  return ((u64)mad_step((u32)(x >> 32), c) << 32) | mad_step((u32)x, c);
}

// Each group of the first round from device memory into registers, n_mults
// steps on every half at once, and back to device memory at the same stride.
template <typename T, int K>
__device__ __forceinline__ void mul_path(const T* __restrict__ gin, T* __restrict__ gout, u32 c,
                                         int n_mults, int logn, bool vec) {
  constexpr int R = 1 << K;
  const int t = 1 << (logn - K);
#pragma unroll 1
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    T x[R];
    load_group<T, R>(x, gin + j, t, vec);
#pragma unroll 1
    for (int k = 0; k < n_mults; ++k) {
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = mad_word(x[i], c);
    }
    store_group<T, R>(x, gout + j, t, vec);
  }
}

template <typename T, int K, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
diag_mul_kernel(const T* __restrict__ in, T* __restrict__ out, u32 c, int n_mults, int logn) {
  const T* gin = in + ((size_t)blockIdx.x << logn);
  T* gout = out + ((size_t)blockIdx.x << logn);
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  switch (logn < K ? logn : K) {
    case 1: mul_path<T, 1>(gin, gout, c, n_mults, logn, vec); break;
    case 2: mul_path<T, kMin<K, 2>>(gin, gout, c, n_mults, logn, vec); break;
    case 3: mul_path<T, kMin<K, 3>>(gin, gout, c, n_mults, logn, vec); break;
    default: mul_path<T, K>(gin, gout, c, n_mults, logn, vec); break;
  }
}

template <typename T>
int launch_mul(const void* in, void* out, u32 c, int n_mults, int batch, int logn,
               void* stream) {
  typedef Fused<T> F;
  return launch_fused<T>(diag_mul_kernel<T, F::kLogR, F::kThreads, kMulMinBlocks>, batch, logn,
                         0, stream, (const T*)in, (T*)out, c, n_mults, logn);
}

// copy_path with n_rounds butterflies of each register pair (u, u + R/2),
// coefficients N/2 apart, under w[1] between the load and the write into
// the exchange buffer.
template <typename T, int K, class Red>
__device__ __forceinline__ void math_path(const T* __restrict__ gin, T* __restrict__ gout,
                                          T* sm, T w1, T wc1, T q, Red red, int n_rounds,
                                          int logn, bool vec) {
  constexpr int R = 1 << K;
  const int t = 1 << (logn - K);
#pragma unroll 1
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    T x[R];
    load_group<T, R>(x, gin + j, t, vec);
#pragma unroll 1
    for (int r = 0; r < n_rounds; ++r) {
#pragma unroll
      for (int u = 0; u < R / 2; ++u) fwd_bfly<T>(x[u], x[u + R / 2], w1, wc1, q, red);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) sm[padded<T>(j + i * t)] = x[i];
  }
  __syncthreads();
  copy_out<T>(gout, sm, 1 << logn, false, (T)0, vec);
}

template <typename T, int K, int THREADS, int MINB, class Red>
__global__ void __launch_bounds__(THREADS, MINB)
diag_math_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                 const T* __restrict__ w_con, T q, int n_rounds, int logn, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const T* gin = in + ((size_t)blockIdx.x << logn);
  T* gout = out + ((size_t)blockIdx.x << logn);
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  const T w1 = __ldg(w + 1), wc1 = Red::kCon ? __ldg(w_con + 1) : (T)0;
#define NTT_MATH(KK) math_path<T, KK, Red>(gin, gout, sm, w1, wc1, q, red, n_rounds, logn, vec)
  switch (logn < K ? logn : K) {
    case 1: NTT_MATH(1); break;
    case 2: NTT_MATH((kMin<K, 2>)); break;
    case 3: NTT_MATH((kMin<K, 3>)); break;
    default: NTT_MATH(K); break;
  }
#undef NTT_MATH
}

template <typename T, class Red>
int launch_math(const void* in, void* out, const void* w, const void* w_con, u64 q,
                int n_rounds, int batch, int logn, void* stream, Red red) {
  typedef Fused<T> F;
  return launch_fused<T>(diag_math_kernel<T, F::kLogR, F::kThreads, F::kMinBlocks, Red>, batch,
                         logn, exchange_bytes<T>(logn), stream, (const T*)in, (T*)out,
                         (const T*)w, (const T*)w_con, (T)q, n_rounds, logn, red);
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
    return ntt::launch_mul<T>(in, out, (ntt::u32)c, n_mults, batch, logn, stream);    \
  }                                                                                   \
  int ntt_diag_math_u##W(const void* in, void* out, const void* w, const void* w_con, \
                         unsigned long long q, int n_rounds, int batch, int logn,     \
                         void* stream) {                                              \
    return ntt::launch_math<T>(in, out, w, w_con, q, n_rounds, batch, logn, stream,   \
                               ntt::ShoupRed());                                      \
  }                                                                                   \
  int ntt_diag_math_solinas_u##W(const void* in, void* out, const void* w,           \
                                 const void* w_con, unsigned long long q,            \
                                 int n_rounds, int batch, int logn, int e, int k,    \
                                 void* stream) {                                      \
    return ntt::launch_math<T>(in, out, w, w_con, q, n_rounds, batch, logn, stream,   \
                               ntt::SolinasRed{e, k});                                \
  }                                                                                   \
  int ntt_diag_moves_u##W(const void* in, void* out, int batch, int logn,            \
                          void* stream) {                                             \
    return ntt::launch_moves<T>(in, out, batch, logn, stream);                        \
  }

NTT_PROBES(32, ntt::u32)
NTT_PROBES(64, ntt::u64)

}  // extern "C"
