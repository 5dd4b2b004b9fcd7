// Register rounds: the building block of the fused transforms K1 / K2
// (ntt_fused.cu) and, on tiles, of the two-pass kernels K4-K7
// (ntt_sixstep.cu).
//
// A round runs K consecutive radix-2 stages of one polynomial with no
// barrier: each thread holds R = 2^K coefficients in registers, the ones
// those K stages pair with each other, and runs the butterflies on them.
// Only between rounds does the block exchange the polynomial through shared
// memory, in place: a thread writes its R words back where it read them, the
// block waits at one barrier, and the next round reads another grouping.
//
// Stage s (0 <= s < log2 N, forward order) pairs a[i] and a[i + t] with
// t = 2^(log2 N - 1 - s) under twiddle index 2^s + (i >> (log2 N - s)).  A
// round over stages s0 .. s0 + K - 1 has the stride T = 2^(log2 N - s0 - K)
// and N / R groups (hi, lo), hi < 2^s0, lo < T; group (hi, lo) holds the
// words base + i T, base = hi R T + lo, i < R.  Local stage r of the round
// pairs registers (i, i + 2^(K-1-r)) under twiddle index ((2^s0 + hi) << r)
// + (i >> (K - r)): the 2^r pairs of a local stage are contiguous in the
// flat tables, so a thread reads each pair its round needs once, R - 1
// pairs a round, with 16-byte loads where 2^r words fill one.
//
// The forward runs its rounds from s0 = 0: the first round takes the
// remainder k0 = log2 N - K (nr - 1) stages (its registers hold R / 2^k0
// whole groups of k0 stages, at stride T = N / R, so its load from device
// memory is coalesced), the others K each; the last round has T = 1, R
// consecutive words a thread, which it writes back to shared memory for one
// coalesced copy out (a warp storing them straight from registers would
// write 32 separate 16-byte pieces an instruction, each in its own 32-byte
// sector).  The inverse is the mirror image: its first round (T = 1) loads R
// consecutive words, its last round (s0 = 0) ends with the fused final stage
// and stores at stride N / R, coalesced.  Every coefficient meets the same
// butterflies under the same twiddles in the same order as in the flat
// radix-2 transform, so the output bits, lazy representatives included, are
// the flat transform's.
//
// Shared memory holds the polynomial padded by one word every bank row (32
// words at word 32, 16 eight-byte words at word 64), so the T = 1 rounds
// and the T >= row rounds read and write without bank conflicts; a round
// with 1 < T < row assigns its groups to threads with the low bits of hi
// rotated, so the threads of one access spread over all banks.
#pragma once

#include <cuda_runtime.h>

#include "modarith.cuh"
#include "poly_block.cuh"

namespace ntt {

// log2 of the words a shared-memory bank row holds: 32 four-byte words or 16
// eight-byte words.
template <typename T>
constexpr int kRowLog = sizeof(T) == 8 ? 4 : 5;

template <typename T>
__device__ __forceinline__ int padded(int x) {
  return x + (x >> kRowLog<T>);
}

// Bytes of shared memory the exchanges of a polynomial of 2^logn words take.
template <typename T>
__host__ __device__ inline size_t exchange_bytes(int logn) {
  const size_t n = (size_t)1 << logn;
  return (n + (n >> kRowLog<T>)) * sizeof(T);
}

template <int A, int B>
constexpr int kMin = A < B ? A : B;

// 16-byte vectors of words and their unpacking.
template <typename T>
struct Vec16;
template <>
struct Vec16<u32> {
  typedef uint4 type;
  static constexpr int n = 4;
  static __device__ __forceinline__ void get(const uint4& v, u32* d) {
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  static __device__ __forceinline__ uint4 make(const u32* s) {
    return make_uint4(s[0], s[1], s[2], s[3]);
  }
};
template <>
struct Vec16<u64> {
  typedef ulonglong2 type;
  static constexpr int n = 2;
  static __device__ __forceinline__ void get(const ulonglong2& v, u64* d) {
    d[0] = v.x;
    d[1] = v.y;
  }
  static __device__ __forceinline__ ulonglong2 make(const u64* s) {
    return make_ulonglong2(s[0], s[1]);
  }
};

// The R words of a group from device memory: 16-byte loads where they are
// consecutive (t == 1) and aligned, else one coalesced word each.
template <typename T, int R>
__device__ __forceinline__ void load_group(T (&x)[R], const T* __restrict__ p, int t,
                                           bool vec) {
  typedef Vec16<T> V;
  if (R >= V::n && t == 1 && vec) {
#pragma unroll
    for (int c = 0; c < R / V::n; ++c)
      V::get(__ldg(reinterpret_cast<const typename V::type*>(p) + c), x + c * V::n);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = __ldg(p + (size_t)i * t);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_group(const T (&x)[R], T* __restrict__ p, int t,
                                            bool vec) {
  typedef Vec16<T> V;
  if (R >= V::n && t == 1 && vec) {
#pragma unroll
    for (int c = 0; c < R / V::n; ++c)
      reinterpret_cast<typename V::type*>(p)[c] = V::make(x + c * V::n);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[(size_t)i * t] = x[i];
  }
}

// Group j of a round with 2^K registers a thread, stride 2^logt, first stage
// s0: sets hi and returns base.  Where 1 < T < row the low bits of hi are
// rotated so that the threads of one access step hi by row / R (and lo
// through all T values): their padded addresses then cover every bank.
template <typename T, int K>
__device__ __forceinline__ int group_base(int j, int logt, int s0, int& hi) {
  constexpr int kRot = kRowLog<T> > K ? kRowLog<T> - K : 0;
  hi = j >> logt;
  if (kRot > 0 && logt > 0 && logt < kRowLog<T>) {
    const int a = kRowLog<T> - logt;
    if (s0 >= a + kRot) {
      const int mask = (1 << (a + kRot)) - 1;
      const int low = hi & mask;
      hi = (hi & ~mask) | (((low << kRot) | (low >> a)) & mask);
    }
  }
  return (hi << (logt + K)) | (j & ((1 << logt) - 1));
}

// Calls f(b, w[first + b], w_con[first + b]) for b < NB, the NB = 2^r pairs
// of a local stage from index first (a multiple of NB), read with 16-byte
// loads where NB pairs fill one.
template <typename T, int NB, typename F>
__device__ __forceinline__ void for_pairs(int first, const T* __restrict__ w,
                                          const T* __restrict__ w_con, F f) {
  typedef Vec16<T> V;
  if constexpr (NB >= V::n) {
#pragma unroll
    for (int b0 = 0; b0 < NB; b0 += V::n) {
      T wv[V::n], wc[V::n];
      V::get(__ldg(reinterpret_cast<const typename V::type*>(w + first + b0)), wv);
      V::get(__ldg(reinterpret_cast<const typename V::type*>(w_con + first + b0)), wc);
#pragma unroll
      for (int c = 0; c < V::n; ++c) f(b0 + c, wv[c], wc[c]);
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) f(b, __ldg(w + first + b), __ldg(w_con + first + b));
  }
}

// Forward local stages r .. ns - 1 on the registers of a group whose first
// twiddle index is mb = 2^s0 + hi.
template <typename T, int K, int r = 0>
__device__ __forceinline__ void fwd_stages(T (&x)[1 << K], const T* __restrict__ w,
                                           const T* __restrict__ w_con, T q, int mb, int ns) {
  if constexpr (r < K) {
    if (r < ns) {
      constexpr int half = (1 << K) >> (r + 1);
      for_pairs<T, 1 << r>(mb << r, w, w_con, [&](int b, T wv, T wc) {
#pragma unroll
        for (int u = 0; u < half; ++u) {
          const int i0 = b * 2 * half + u;
          fwd_bfly<T>(x[i0], x[i0 + half], wv, wc, q);
        }
      });
      fwd_stages<T, K, r + 1>(x, w, w_con, q, mb, ns);
    }
  }
}

// Inverse local stages r .. 0, each where r < ns; with final, local stage 0 is
// the fused final stage (stage 0 of the transform, n^-1 folded in).
template <typename T, int K, int r = K - 1>
__device__ __forceinline__ void inv_stages(T (&x)[1 << K], const T* __restrict__ w,
                                           const T* __restrict__ w_con, T q,
                                           const FinalConsts<T>& fc, int mb, int ns,
                                           bool final) {
  if constexpr (r >= 0) {
    constexpr int half = (1 << K) >> (r + 1);
    if (r < ns) {
      if (r == 0 && final) {
#pragma unroll
        for (int u = 0; u < half; ++u) bkw_final<T>(x[u], x[u + half], fc, q);
      } else {
        for_pairs<T, 1 << r>(mb << r, w, w_con, [&](int b, T wv, T wc) {
#pragma unroll
          for (int u = 0; u < half; ++u) {
            const int i0 = b * 2 * half + u;
            bkw_bfly<T>(x[i0], x[i0 + half], wv, wc, q);
          }
        });
      }
    }
    inv_stages<T, K, r - 1>(x, w, w_con, q, fc, mb, ns, final);
  }
}

// One round over stages s0 .. s0 + ns - 1 (ns <= K) of the block's
// polynomial, forward or inverse: each group from device memory (gin) or
// shared memory, its stages in registers, and back to device memory (gout)
// or shared memory.
template <typename T, int K, bool INV>
__device__ __forceinline__ void run_round(const T* __restrict__ gin, T* __restrict__ gout,
                                          T* sm, const T* __restrict__ w,
                                          const T* __restrict__ w_con, T q,
                                          const FinalConsts<T>& fc, int logn, int s0, int ns,
                                          bool vec) {
  constexpr int R = 1 << K;
  const int logt = logn - s0 - K;
  const int t = 1 << logt;
  const int groups = 1 << (logn - K);
#pragma unroll 1
  for (int j = threadIdx.x; j < groups; j += blockDim.x) {
    int hi;
    const int base = group_base<T, K>(j, logt, s0, hi);
    T x[R];
    if (gin) {
      load_group<T, R>(x, gin + base, t, vec);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = sm[padded<T>(base + i * t)];
    }
    if constexpr (INV) {
      inv_stages<T, K>(x, w, w_con, q, fc, (1 << s0) + hi, ns, s0 == 0);
    } else {
      fwd_stages<T, K>(x, w, w_con, q, (1 << s0) + hi, ns);
    }
    if (gout) {
      store_group<T, R>(x, gout + base, t, vec);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) sm[padded<T>(base + i * t)] = x[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Rounds on a tile: 2^vlog independent transforms of 2^logn words each in one
// block (K4 / K7: the TC columns of an (N1, TC) column tile; K5 / K6: the TR
// rows of a row tile; ntt_sixstep.cu).  Each transform runs the rounds above
// with its own twiddle base: the first twiddle index of group hi in a round
// from s0 is (base << s0) + hi, base 1 for the whole polynomial and for the
// columns (column stage s of row r is flat stage s, index 2^s + (r >> (log2
// N1 - s))), N1 + r for row r (row stage s' of word k is flat stage log2 N1 +
// s', index ((N1 + r) << s') + (k >> (log2 N2 - s'))).  So every word meets
// the flat transform's butterflies and twiddles, forward or inverse, and the
// bits, lazy representatives included, are the flat transform's.
//
// The kernel supplies the map, a Tile with
//   logn, vlog               the transforms' size and count (log2);
//   lane(j, glog, v, g)      group g of transform v that thread slot j
//                            takes (2^glog groups a transform);
//   dev(v, x)                word x of transform v in device memory,
//                            relative to the tile's start;
//   sm(v, x)                 word x of transform v in the exchange buffer;
//   base(v)                  the transform's twiddle base;
//   vec                      true where a transform's words are contiguous
//                            in device memory and 16-byte aligned: the
//                            inverse then moves a T = 1 round's R words
//                            with 16-byte loads and stores.
// ---------------------------------------------------------------------------

// One round over stages s0 .. s0 + ns - 1 of every transform of the tile,
// forward or inverse (with final, local stage 0 at s0 = 0 is the fused final
// stage): each group from device memory (gin) or the exchange buffer, its
// stages in registers, and back to device memory (gout) or the exchange
// buffer.
template <typename T, int K, bool INV = false, class Tile>
__device__ __forceinline__ void tile_round(const Tile& tl, const T* __restrict__ gin,
                                           T* __restrict__ gout, T* sm,
                                           const T* __restrict__ w,
                                           const T* __restrict__ w_con, T q, int s0, int ns,
                                           const FinalConsts<T>& fc = FinalConsts<T>(),
                                           bool final = false) {
  constexpr int R = 1 << K;
  const int logt = tl.logn - s0 - K;
  const int t = 1 << logt;
  const int glog = tl.logn - K;
  const int slots = 1 << (glog + tl.vlog);
  bool vec = false;
  if constexpr (INV) vec = logt == 0 && tl.vec;
#pragma unroll 1
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    int v, g, hi;
    tl.lane(j, glog, v, g);
    const int base = group_base<T, K>(g, logt, s0, hi);
    T x[R];
    if (gin) {
      if (vec) {
        load_group<T, R>(x, gin + tl.dev(v, base), 1, true);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) x[i] = __ldg(gin + tl.dev(v, base + i * t));
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = sm[tl.sm(v, base + i * t)];
    }
    if constexpr (INV) {
      inv_stages<T, K>(x, w, w_con, q, fc, (tl.base(v) << s0) + hi, ns, final && s0 == 0);
    } else {
      fwd_stages<T, K>(x, w, w_con, q, (tl.base(v) << s0) + hi, ns);
    }
    if (gout) {
      if (vec) {
        store_group<T, R>(x, gout + tl.dev(v, base), 1, true);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) gout[tl.dev(v, base + i * t)] = x[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) sm[tl.sm(v, base + i * t)] = x[i];
    }
  }
}

// The stages of the first of the rounds of K stages that 2^logn words need:
// the first takes the remainder, the others K each.
template <int K>
__host__ __device__ inline int first_round_stages(int logn) {
  const int nr = (logn + K - 1) / K;
  return logn - K * (nr - 1);
}

// The whole forward of every transform of the tile in rounds of K stages
// (1 <= K <= logn): the first round from device memory, the last to device
// memory (gout) or, with gout null, to the exchange buffer; one barrier
// between two rounds.
template <typename T, int K, class Tile>
__device__ __forceinline__ void tile_forward(const Tile& tl, const T* __restrict__ gin,
                                             T* __restrict__ gout, T* sm,
                                             const T* __restrict__ w,
                                             const T* __restrict__ w_con, T q) {
  for (int s0 = 0, ns = first_round_stages<K>(tl.logn); s0 < tl.logn; s0 += ns, ns = K) {
    const bool last = s0 + ns == tl.logn;
    tile_round<T, K>(tl, s0 == 0 ? gin : nullptr, last ? gout : nullptr, sm, w, w_con, q, s0,
                     ns);
    if (!last) __syncthreads();
  }
}

// The whole inverse of every transform of the tile in rounds of K stages (1 <=
// K <= logn), the mirror image of tile_forward: rounds from s0 = logn - K
// down, the first (T = 1, R consecutive words) from device memory (gin) or,
// with gin null, from the exchange buffer, the last (s0 = 0, the remainder
// stages, stride 2^logn / R) to device memory, with final ending in the fused
// final stage; one barrier between two rounds.
template <typename T, int K, class Tile>
__device__ __forceinline__ void tile_inverse(const Tile& tl, const T* __restrict__ gin,
                                             T* __restrict__ gout, T* sm,
                                             const T* __restrict__ w,
                                             const T* __restrict__ w_con, T q,
                                             const FinalConsts<T>& fc, bool final) {
  const int nr = (tl.logn + K - 1) / K;
  for (int rd = 1; rd <= nr; ++rd) {
    const bool last = rd == nr;
    tile_round<T, K, true>(tl, rd == 1 ? gin : nullptr, last ? gout : nullptr, sm, w, w_con,
                           q, last ? 0 : tl.logn - K * rd,
                           last ? first_round_stages<K>(tl.logn) : K, fc, final);
    if (!last) __syncthreads();
  }
}

// The polynomial from padded shared memory to device memory, 16-byte stores
// where aligned (strict: reduced below q on the way out).
template <typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ g, const T* sm, int n, bool strict,
                                         T q, bool vec) {
  typedef Vec16<T> V;
  if (vec && n >= V::n) {
    for (int v = threadIdx.x; v < n / V::n; v += blockDim.x) {
      T d[V::n];
#pragma unroll
      for (int c = 0; c < V::n; ++c) {
        const T x = sm[padded<T>(v * V::n + c)];
        d[c] = strict ? reduce_4q_to_q<T>(x, q) : x;
      }
      reinterpret_cast<typename V::type*>(g)[v] = V::make(d);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const T x = sm[padded<T>(i)];
      g[i] = strict ? reduce_4q_to_q<T>(x, q) : x;
    }
  }
}

// The whole transform of the block's polynomial in rounds of K stages (K <=
// logn).  The forward runs its rounds from s0 = 0, the first with the
// remainder stages, the last back into shared memory, and stores from there;
// the inverse runs from s0 = logn - K down to 0, the last round with the
// remainder stages and the fused final stage, and stores from registers.
template <typename T, int K, bool INV>
__device__ __forceinline__ void body(const T* __restrict__ in, T* __restrict__ out, T* sm,
                                     const T* __restrict__ w, const T* __restrict__ w_con, T q,
                                     const FinalConsts<T>& fc, int logn, bool strict) {
  const T* gin = in + ((size_t)blockIdx.x << logn);
  T* gout = out + ((size_t)blockIdx.x << logn);
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  const int nr = (logn + K - 1) / K;
  const int k0 = logn - K * (nr - 1);
  for (int rd = 0, s0 = 0; rd < nr; ++rd) {
    const bool last = rd == nr - 1;
    int ns = rd == 0 ? k0 : K;
    if (INV) {
      ns = last ? k0 : K;
      s0 = last ? 0 : logn - K * (rd + 1);
    }
    run_round<T, K, INV>(rd == 0 ? gin : nullptr, INV && last ? gout : nullptr, sm, w, w_con,
                         q, fc, logn, s0, ns, vec);
    if (!INV) s0 += ns;
    if (!last || !INV) __syncthreads();
  }
  if (!INV) copy_out<T>(gout, sm, 1 << logn, strict, q, vec);
}

// K1 (INV false) and K2 (INV true): one block per polynomial, rounds of up
// to K stages (fewer where N < 2^K).
template <typename T, int K, int THREADS, int MINB, bool INV>
__global__ void __launch_bounds__(THREADS, MINB)
rounds_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
              const T* __restrict__ w_con, T q, FinalConsts<T> fc, int logn, int strict) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
#define NTT_BODY(KK) body<T, KK, INV>(in, out, sm, w, w_con, q, fc, logn, strict)
  switch (logn < K ? logn : K) {
    case 1: NTT_BODY(1); break;
    case 2: NTT_BODY((kMin<K, 2>)); break;
    case 3: NTT_BODY((kMin<K, 3>)); break;
    default: NTT_BODY(K); break;
  }
#undef NTT_BODY
}

// K1 / K2's design point at each width (ntt_fused.cu): 2^kLogR coefficients a
// thread, at most kThreads threads a block, at least kMinBlocks blocks an SM
// (which bounds the registers a thread).
template <typename T>
struct Fused;
template <>
struct Fused<u32> {
  static constexpr int kLogR = 4, kThreads = 512, kMinBlocks = 2;
};
template <>
struct Fused<u64> {
  static constexpr int kLogR = 4, kThreads = 512, kMinBlocks = 1;
};

// One launch of K1 (INV false; strict or lazy) or K2 (INV true; fc: its
// final stage's constants) at the design point over batch polynomials of N =
// 2^logn: batch blocks of one thread a group (N / 2^kLogR of them), at most
// kThreads, each then taking several groups a round; the cudaError_t of the
// launch.
template <typename T, bool INV>
int launch_rounds(const void* in, void* out, const void* w, const void* w_con, u64 q,
                  const FinalConsts<T>& fc, int batch, int logn, int strict, void* stream) {
  typedef Fused<T> F;
  constexpr int K = F::kLogR;
  if (batch < 1 || logn < 1 || logn > 24) return (int)cudaErrorInvalidValue;
  const int groups = 1 << (logn - (logn < K ? logn : K));
  const int threads = groups < F::kThreads ? groups : F::kThreads;
  const size_t smem = (logn > K || !INV) ? exchange_bytes<T>(logn) : 0;
  return launch_blocks(rounds_kernel<T, K, F::kThreads, F::kMinBlocks, INV>, batch, threads,
                       smem, stream, (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q,
                       fc, logn, strict);
}

}  // namespace ntt
