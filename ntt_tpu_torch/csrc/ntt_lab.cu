// The lab's forward candidates, the same function as K1 (ntt_fused.cu) with
// the stages grouped otherwise, at word 32 (q < 2^30) and word 64
// (q < 2^62), strict or lazy, in the standard or the kept-transposed layout.
//
//   L1 fwd_v2_kernel<T, G, Red>  replaces _fwd_kernel_v2
//       (tools/pallas_lab.py:127, through fwd_fused_v2 :166): K1's flat
//       radix-2 stages in place, in six-step rounds.  The column phase
//       (stages 0 .. log2 N1 - 1) and the row phase (the rest) each run in
//       rounds of G stages, a phase with an odd count ending in a one-stage
//       round (make_rounds :93); no round crosses the phase boundary.
//   L2 fwd_v3_kernel<T, W, MINB, Red>  replaces _fwd_kernel_v3 (:326,
//       through fwd_fused_v3 :353): the Stockham constant-geometry flow,
//       out of place.  Each stage of a phase pairs the two halves of the
//       phase's axis, positions (i, i + L/2), and writes the interleave
//       (2i, 2i + 1), under w[2^s + (i mod 2^s)] in the column phase and
//       w[2^s N1 + c 2^s + (i mod 2^s)] in the row phase of row c (the
//       Pallas stockham_col_stack / stockham_row_stack :277-298).
//
// Both run at K1's design point (rounds.cuh, with nothing re-tuned):
// Fused<T>'s 512 threads at most and 16 words a thread, one block an SM at
// word 64 and two at word 32; the polynomial between rounds in the padded
// exchange buffer of exchange_bytes<T>(logn); the first round read from
// device memory straight into registers at a coalesced stride; the last
// round back into the buffer and out through copy_out's coalesced 16-byte
// stores (kept transposed: each output word read from its transposed place,
// the device side still coalesced); each twiddle pair a group needs read
// once, with 16-byte loads where the pairs fill one (for_pairs);
// launch_fused.  So K1, L1 and L2 differ only in their algorithms:
//
//   K1  rounds of 4 stages in place, the remainder first: 3 exchanges at
//       N = 2^14;
//   L1  in-place rounds of G stages that stop at the N1 | N2 boundary: at
//       N = 2^14, n1_log 7, 7 exchanges at G = 2 and 13 at G = 1.  A round
//       over stages s0 .. s0 + G - 1 is a group of 16 words of K1's rounds
//       (stride 2^(log2 N - a - 4), a = min(s0, log2 N - 4)) running its
//       local stages s0 - a .. s0 - a + G - 1: the window starts at s0 until
//       the last rounds, which run the last local stages of a group of 16
//       consecutive words;
//   L2  the same 16 words of the phase's axis read in every round, the
//       positions p + j L/16 (j < 16, p < L/16), which close under 4
//       Stockham stages: their butterflies are K1's local stages, and after
//       4 stages register j holds position 16 p + j.  A phase of l stages
//       runs ceil(l / 4) such rounds, the remainder first (a round of
//       ns < 4 stages runs the first ns local stages and writes register j
//       to the rotation by ns of its position); a phase shorter than 16
//       words reads it whole.  Out of place with one buffer: each round
//       reads all of a thread's words, waits at a barrier, writes them, and
//       waits again, so a thread holds all of its words across the barrier
//       (W = N / threads: 16, and 32 / 64 at the N that give a thread two /
//       four groups; at 64, word 32 at N = 2^15, whose shared memory leaves
//       room for one block an SM anyway, the instantiation takes one
//       block's registers).
//
// Every coefficient meets the flat radix-2 butterflies with the same
// twiddles in the same order, so the output is bit for bit K1's and the
// plain six-step's at the same split (fused_lab.plain), lazy
// representatives included.
//
// What bounds them on an H100: device memory sees each coefficient once in
// and once out, plus the twiddles, which stay in L2; the rest is K1's split
// (PERF.md section 5): the butterflies, and an exchange through shared
// memory and a barrier a round, which L1 pays 2-4 times as often as K1 and
// L2 twice a round.  Two buffers (ping-pong) would save L2's second barrier
// a round but do not fit at N = 2^14, word 64 (2 x 136 KB).  Holding 32
// words a thread, L2 spills at N = 2^14; staging the words beyond 16
// through a second area of shared memory, or loading every group before
// any stage, ran slower on the card than these spills (PERF.md section 6).
//
// Every single product goes through the reduction policy Red of modarith.cuh:
// ShoupRed, or under the NTT_MULMOD=solinas switch SolinasRed, the two-fold
// Solinas product of the JAX lab's butterflies at q = 2^e - 2^k + 1
// (tools/pallas_lab.py through ops.fwd_bfly), which reads no Shoup constant.
// The Solinas entry points take the Shoup ones' arguments with (e, k) before
// the stream; both policies' launchers refuse the same shapes: an N beyond
// one block's shared memory (K1's limit, fused.max_logn).
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "rounds.cuh"

namespace ntt {
namespace {

// The polynomial from the exchange buffer to device memory (strict: reduced
// below q), in the (N1, N2) layout or the (N2, N1) one: output o = j2 N1 + j1
// holds coefficient j1 N2 + j2, each thread storing consecutive o.
template <typename T>
__device__ __forceinline__ void store_lab(T* __restrict__ g, const T* sm, T q, int logn,
                                          int n1_log, bool strict, bool keep_t, bool vec) {
  if (!keep_t) {
    copy_out<T>(g, sm, 1 << logn, strict, q, vec);
    return;
  }
  const int n2_log = logn - n1_log;
  for (int o = threadIdx.x; o < (1 << logn); o += blockDim.x) {
    const T x = sm[padded<T>(((o & ((1 << n1_log) - 1)) << n2_log) | (o >> n1_log))];
    g[o] = strict ? reduce_4q_to_q<T>(x, q) : x;
  }
}

// Local stages r0 .. r1 - 1 of a group of 2^K registers whose first twiddle
// index is mb (rounds.cuh's fwd_stages from a local stage other than 0).
template <typename T, int K, class Red, int r = 0>
__device__ __forceinline__ void window_stages(T (&x)[1 << K], const T* __restrict__ w,
                                              const T* __restrict__ w_con, T q, Red red,
                                              int mb, int r0, int r1) {
  if constexpr (r < K) {
    if (r >= r0 && r < r1) {
      constexpr int half = (1 << K) >> (r + 1);
      for_pairs<T, 1 << r, Red>(mb << r, w, w_con, [&](int b, T wv, T wc) {
#pragma unroll
        for (int u = 0; u < half; ++u) {
          const int i0 = b * 2 * half + u;
          fwd_bfly<T>(x[i0], x[i0 + half], wv, wc, q, red);
        }
      });
    }
    window_stages<T, K, Red, r + 1>(x, w, w_con, q, red, mb, r0, r1);
  }
}

// One L1 round, stages s0 .. s0 + ns - 1 in place: each group of 2^K words
// of the window from a = min(s0, logn - K) from device memory (gin) or the
// exchange buffer, its local stages s0 - a .. s0 - a + ns - 1, and back to
// the buffer.
template <typename T, int K, class Red>
__device__ __forceinline__ void v2_round(const T* __restrict__ gin, T* sm,
                                         const T* __restrict__ w, const T* __restrict__ w_con,
                                         T q, Red red, int logn, int s0, int ns, bool vec) {
  constexpr int R = 1 << K;
  const int a = s0 < logn - K ? s0 : logn - K;
  const int logt = logn - a - K;
  const int t = 1 << logt;
#pragma unroll 1
  for (int j = threadIdx.x; j < (1 << (logn - K)); j += blockDim.x) {
    int hi;
    const int base = group_base<T, K>(j, logt, a, hi);
    T x[R];
    if (gin) {
      load_group<T, R>(x, gin + base, t, vec);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = sm[padded<T>(base + i * t)];
    }
    window_stages<T, K, Red>(x, w, w_con, q, red, (1 << a) + hi, s0 - a, s0 - a + ns);
#pragma unroll
    for (int i = 0; i < R; ++i) sm[padded<T>(base + i * t)] = x[i];
  }
}

template <typename T, int K, int G, class Red>
__device__ __forceinline__ void v2_body(const T* __restrict__ in, T* __restrict__ out, T* sm,
                                        const T* __restrict__ w, const T* __restrict__ w_con,
                                        T q, Red red, int logn, int n1_log, bool strict,
                                        bool keep_t) {
  const T* gin = in + ((size_t)blockIdx.x << logn);
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  for (int phase = 0; phase < 2; ++phase) {
    const int end = phase ? logn : n1_log;
    for (int s = phase ? n1_log : 0; s < end;) {
      const int ns = s + G <= end ? G : 1;
      v2_round<T, K, Red>(s == 0 ? gin : nullptr, sm, w, w_con, q, red, logn, s, ns, vec);
      __syncthreads();
      s += ns;
    }
  }
  store_lab<T>(out + ((size_t)blockIdx.x << logn), sm, q, logn, n1_log, strict, keep_t, vec);
}

template <typename T, int G, class Red>
__global__ void __launch_bounds__(Fused<T>::kThreads, Fused<T>::kMinBlocks)
fwd_v2_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
              const T* __restrict__ w_con, T q, int logn, int n1_log, int strict,
              int keep_t, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int K = Fused<T>::kLogR;
#define NTT_V2(KK) \
  v2_body<T, KK, G, Red>(in, out, sm, w, w_con, q, red, logn, n1_log, strict, keep_t)
  switch (logn < K ? logn : K) {
    case 1: NTT_V2(1); break;
    case 2: NTT_V2((kMin<K, 2>)); break;
    case 3: NTT_V2((kMin<K, 3>)); break;
    default: NTT_V2(K); break;
  }
#undef NTT_V2
}

// One phase of L2's Stockham flow in the (N1, N2) view: 2^(logn - l)
// transforms of L = 2^l words along the phase's axis, the columns (col:
// transform v is column v, axis position i at i N2 + v, twiddle base 1) or
// the rows (row v, position i at v N2 + i, twiddle base N1 + v).  Group
// (v, p) of a round holds the 2^K positions p + j L / 2^K, j < 2^K; its
// index gi puts v lowest for the columns and p lowest for the rows, so the
// threads of a warp read consecutive words.
struct StockhamPhase {
  bool col;
  int l, n2_log, n1;

  // (v, p) of group gi, and the word of axis position i of transform v.
  __device__ __forceinline__ void group(int gi, int plog, int& v, int& p) const {
    if (col) {
      v = gi & ((1 << n2_log) - 1);
      p = gi >> n2_log;
    } else {
      v = gi >> plog;
      p = gi & ((1 << plog) - 1);
    }
  }
  __device__ __forceinline__ int word(int v, int i) const {
    return col ? (i << n2_log) | v : (v << n2_log) | i;
  }
};

// One L2 round of ns <= K stages from phase stage s0: every group of the
// thread (W / 2^K of them, gi = threadIdx.x + k blockDim.x) from device
// memory (gin) or the exchange buffer into registers, its first ns local
// stages under twiddle base ((base << s0) + p mod 2^s0), a barrier where it
// read the buffer, then register j to the rotation of its position by ns
// (16 p + j after a whole round), and a barrier.
template <typename T, int K, int W, class Red>
__device__ __forceinline__ void v3_round(const StockhamPhase& ph, const T* __restrict__ gin,
                                         T* sm, const T* __restrict__ w,
                                         const T* __restrict__ w_con, T q, Red red, int s0,
                                         int ns) {
  constexpr int R = 1 << K, NG = W / R;
  const int plog = ph.l - K;
  const int mask = (1 << ph.l) - 1;
  T x[NG][R];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    int v, p;
    ph.group(threadIdx.x + k * blockDim.x, plog, v, p);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int at = ph.word(v, p + (j << plog));
      x[k][j] = gin ? __ldg(gin + at) : sm[padded<T>(at)];
    }
    const int base = ph.col ? 1 : ph.n1 + v;
    fwd_stages<T, K, Red>(x[k], w, w_con, q, red, (base << s0) + (p & ((1 << s0) - 1)), ns);
  }
  if (!gin) __syncthreads();
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    int v, p;
    ph.group(threadIdx.x + k * blockDim.x, plog, v, p);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int i = (p << K) | j;
      if (ns < K) {
        i = p + (j << plog);
        i = ((i << ns) | (i >> (ph.l - ns))) & mask;
      }
      sm[padded<T>(ph.word(v, i))] = x[k][j];
    }
  }
  __syncthreads();
}

// A phase's rounds of up to K stages, the remainder first.
template <typename T, int K, int W, class Red>
__device__ __forceinline__ void v3_phase(const StockhamPhase& ph, const T* __restrict__ gin,
                                         T* sm, const T* __restrict__ w,
                                         const T* __restrict__ w_con, T q, Red red) {
  const int nr = (ph.l + K - 1) / K;
  for (int rd = 0, s0 = 0; rd < nr; ++rd) {
    const int ns = rd == 0 ? ph.l - K * (nr - 1) : K;
    v3_round<T, K, W, Red>(ph, rd == 0 ? gin : nullptr, sm, w, w_con, q, red, s0, ns);
    s0 += ns;
  }
}

__host__ __device__ constexpr int log2_of(int w) { return w <= 1 ? 0 : 1 + log2_of(w / 2); }

// L2 with W words a thread (N / threads); MINB blocks an SM.
template <typename T, int W, int MINB, class Red>
__global__ void __launch_bounds__(Fused<T>::kThreads, MINB)
fwd_v3_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
              const T* __restrict__ w_con, T q, int logn, int n1_log, int strict,
              int keep_t, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int K = kMin<Fused<T>::kLogR, log2_of(W)>;
  const T* gin = in + ((size_t)blockIdx.x << logn);
  for (int phase = 0; phase < 2; ++phase) {
    const StockhamPhase ph{phase == 0, phase ? logn - n1_log : n1_log, logn - n1_log,
                           1 << n1_log};
    const T* src = phase ? nullptr : gin;
#define NTT_V3(KK) v3_phase<T, KK, W, Red>(ph, src, sm, w, w_con, q, red)
    switch (ph.l < K ? ph.l : K) {
      case 0: break;
      case 1: NTT_V3(1); break;
      case 2: NTT_V3((kMin<K, 2>)); break;
      case 3: NTT_V3((kMin<K, 3>)); break;
      default: NTT_V3(K); break;
    }
#undef NTT_V3
  }
  const bool vec = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  store_lab<T>(out + ((size_t)blockIdx.x << logn), sm, q, logn, n1_log, strict, keep_t, vec);
}

template <typename T, class Red = ShoupRed>
int launch_v2(const void* in, void* out, const void* w, const void* w_con, u64 q,
              int batch, int logn, int n1_log, int group, int strict, int keep_t,
              void* stream, Red red = Red()) {
  if (n1_log < 1 || n1_log > logn) return (int)cudaErrorInvalidValue;
  if (group != 1 && group != 2) return (int)cudaErrorInvalidValue;
  return launch_fused<T>(group == 1 ? fwd_v2_kernel<T, 1, Red> : fwd_v2_kernel<T, 2, Red>,
                         batch, logn, exchange_bytes<T>(logn), stream, (const T*)in, (T*)out,
                         (const T*)w, (const T*)w_con, (T)q, logn, n1_log, strict, keep_t,
                         red);
}

// L2's blocks an SM at W words a thread: K1's, or one where a thread holds
// more than 128 bytes (word 32 at N = 2^15, whose 132 KB of shared memory
// leave room for one block an SM anyway).
template <typename T, int W>
constexpr int kV3MinBlocks = W * (int)sizeof(T) > 128 ? 1 : Fused<T>::kMinBlocks;

template <typename T, class Red = ShoupRed>
int launch_v3(const void* in, void* out, const void* w, const void* w_con, u64 q,
              int batch, int logn, int n1_log, int strict, int keep_t, void* stream,
              Red red = Red()) {
  typedef Fused<T> F;
  if (n1_log < 1 || n1_log > logn || logn > 24) return (int)cudaErrorInvalidValue;
  const int groups = 1 << (logn - (logn < F::kLogR ? logn : F::kLogR));
  const int words = (1 << logn) / (groups < F::kThreads ? groups : F::kThreads);
  void (*kernel)(const T*, T*, const T*, const T*, T, int, int, int, int, Red) = nullptr;
  switch (words) {
    case 2: kernel = fwd_v3_kernel<T, 2, kV3MinBlocks<T, 2>, Red>; break;
    case 4: kernel = fwd_v3_kernel<T, 4, kV3MinBlocks<T, 4>, Red>; break;
    case 8: kernel = fwd_v3_kernel<T, 8, kV3MinBlocks<T, 8>, Red>; break;
    case 16: kernel = fwd_v3_kernel<T, 16, kV3MinBlocks<T, 16>, Red>; break;
    case 32: kernel = fwd_v3_kernel<T, 32, kV3MinBlocks<T, 32>, Red>; break;
    case 64:
      if constexpr (sizeof(T) == 4) kernel = fwd_v3_kernel<T, 64, kV3MinBlocks<T, 64>, Red>;
      break;
  }
  if (!kernel) return (int)cudaErrorInvalidValue;  // beyond one block's shared memory
  return launch_fused<T>(kernel, batch, logn, exchange_bytes<T>(logn), stream, (const T*)in,
                         (T*)out, (const T*)w, (const T*)w_con, (T)q, logn, n1_log, strict,
                         keep_t, red);
}

}  // namespace
}  // namespace ntt

// Plain C interface, loaded with ctypes by ntt_tpu_torch/native.py: one launch
// of batch blocks on `stream`, N = 2^logn, N1 = 2^n1_log; returns the
// cudaError_t of the launch.
extern "C" {

int ntt_fwd_fused_v2_u32(const void* in, void* out, const void* w, const void* w_con,
                         unsigned long long q, int batch, int logn, int n1_log, int group,
                         int strict, int keep_t, void* stream) {
  return ntt::launch_v2<ntt::u32>(in, out, w, w_con, q, batch, logn, n1_log, group, strict,
                                  keep_t, stream);
}

int ntt_fwd_fused_v2_u64(const void* in, void* out, const void* w, const void* w_con,
                         unsigned long long q, int batch, int logn, int n1_log, int group,
                         int strict, int keep_t, void* stream) {
  return ntt::launch_v2<ntt::u64>(in, out, w, w_con, q, batch, logn, n1_log, group, strict,
                                  keep_t, stream);
}

int ntt_fwd_fused_v3_u32(const void* in, void* out, const void* w, const void* w_con,
                         unsigned long long q, int batch, int logn, int n1_log, int strict,
                         int keep_t, void* stream) {
  return ntt::launch_v3<ntt::u32>(in, out, w, w_con, q, batch, logn, n1_log, strict, keep_t,
                                  stream);
}

int ntt_fwd_fused_v3_u64(const void* in, void* out, const void* w, const void* w_con,
                         unsigned long long q, int batch, int logn, int n1_log, int strict,
                         int keep_t, void* stream) {
  return ntt::launch_v3<ntt::u64>(in, out, w, w_con, q, batch, logn, n1_log, strict, keep_t,
                                  stream);
}

#define NTT_LAB_SOLINAS(W)                                                                \
  int ntt_fwd_fused_v2_solinas_u##W(const void* in, void* out, const void* w,              \
                                    const void* w_con, unsigned long long q, int batch,    \
                                    int logn, int n1_log, int group, int strict,           \
                                    int keep_t, int e, int k, void* stream) {              \
    return ntt::launch_v2<ntt::u##W>(in, out, w, w_con, q, batch, logn, n1_log, group,      \
                                     strict, keep_t, stream, ntt::SolinasRed{e, k});        \
  }                                                                                         \
  int ntt_fwd_fused_v3_solinas_u##W(const void* in, void* out, const void* w,              \
                                    const void* w_con, unsigned long long q, int batch,    \
                                    int logn, int n1_log, int strict, int keep_t, int e,   \
                                    int k, void* stream) {                                 \
    return ntt::launch_v3<ntt::u##W>(in, out, w, w_con, q, batch, logn, n1_log, strict,     \
                                     keep_t, stream, ntt::SolinasRed{e, k});                \
  }

NTT_LAB_SOLINAS(32)
NTT_LAB_SOLINAS(64)

#undef NTT_LAB_SOLINAS

}  // extern "C"
