// The lab's forward candidates, the same function as K1 (ntt_fused.cu) with
// the stages grouped otherwise, at word 32 (q < 2^30) and word 64
// (q < 2^62), strict or lazy, in the standard or the kept-transposed layout.
//
//   L1 fwd_v2_kernel<T, G>  replaces _fwd_kernel_v2 (tools/pallas_lab.py:127,
//       through fwd_fused_v2 :166).  The column phase (stages 0 .. log2 N1 - 1)
//       and the row phase (the rest) each run in rounds of G stages:
//       G = 1 is K1's first design, a radix-2 stage with one __syncthreads()
//       a stage; G = 2 lets each thread load four coefficients (c0, c1, c2,
//       c3 a quarter of the group apart), run two stages on them in
//       registers (the pairs (c0, c2), (c1, c3) under w[m + g], then
//       (c0, c1) under w[2m + 2g] and (c2, c3) under w[2m + 2g + 1], the
//       Pallas _round_r4 :67) and store them back in place, with one barrier
//       a round: half the barriers and half the shared-memory traffic.  A
//       phase with an odd stage count ends with a radix-2 round (make_rounds
//       :93).
//   L2 fwd_v3_kernel<T>  replaces _fwd_kernel_v3 (:326, through fwd_fused_v3
//       :353): the Stockham constant-geometry flow.  Every stage pairs the
//       contiguous halves of the phase's axis and writes the results
//       interleaved; its twiddles are read from the flat tables at
//       w[2^s + (i mod 2^s)] in the column phase and
//       w[2^s N1 + c 2^s + (i mod 2^s)] in the row phase (the Pallas
//       stockham_col_stack / stockham_row_stack :277-298).
//
// L1 and L2 take N = N1 * N2 viewed (N1, N2) in shared memory.  The Pallas
// kernels transpose between the phases because Mosaic runs a phase along
// sublanes; here the row phase indexes the (N1, N2) tile in place, and only
// the kept-transposed store ((N2, N1) out) permutes.  Every coefficient meets
// the flat radix-2 butterflies with the same twiddles, so the output is bit
// for bit K1's and the plain six-step's at the same split (fused_lab.plain).
//
// What bounds L1 and L2 on an H100: as K1's first design, the per-stage
// shared-memory traffic and block-wide barriers of one polynomial a block
// (128 KB at N = 2^14, word 64: one block per SM); device memory sees one
// load and one store of each coefficient plus the twiddle tables from L2.
// L1 at G = 2 halves the barriers and the shared-memory round trips.
//
// L2 is out of place: a stage reads both halves and writes the interleave
// over them.  Two tiles (ping-pong) do not fit at N = 2^14, word 64
// (2 x 128 KB against 227 KB), and at word 32 would halve the blocks an SM
// holds, so every stage goes through registers: each thread reads its pairs
// (N/2 / threads of them, at most 64 bytes' worth of words), runs their
// butterflies, waits at a barrier, writes the interleave, and waits again:
// two barriers a stage where L1 at G = 1 has one.
//
// Every single product goes through the reduction policy Red of modarith.cuh
// (fwd_v2_kernel<T, G, Red>, fwd_v3_kernel<T, Red>): ShoupRed, or under the
// NTT_MULMOD=solinas switch SolinasRed, the two-fold Solinas product of the
// JAX lab's butterflies at q = 2^e - 2^k + 1 (tools/pallas_lab.py through
// ops.fwd_bfly), which reads no Shoup constant.  The Solinas entry points
// take the Shoup ones' arguments with (e, k) before the stream; L2's launcher
// rejects the same shapes under either policy.
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "poly_block.cuh"

namespace ntt {
namespace {

// Store the polynomial, strict or lazy, in the (N1, N2) layout or the (N2, N1)
// one: output o = j2 * N1 + j1 holds coefficient j1 * N2 + j2.
template <typename T>
__device__ __forceinline__ void store_poly(const T* a, T* __restrict__ out, T q, int logn,
                                           int n1_log, int strict, int keep_t) {
  const int n = 1 << logn;
  const int n2_log = logn - n1_log;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int i = keep_t ? ((o & ((1 << n1_log) - 1)) << n2_log) | (o >> n1_log) : o;
    const T v = a[i];
    out[o] = strict ? reduce_4q_to_q<T>(v, q) : v;
  }
}

template <typename T, int G, class Red>
__global__ void __launch_bounds__(kMaxThreads)
fwd_v2_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
              const T* __restrict__ w_con, T q, int logn, int n1_log, int strict,
              int keep_t, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const size_t base = (size_t)blockIdx.x << logn;
  load_poly<T>(a, in + base, n);

  for (int phase = 0; phase < 2; ++phase) {
    const int end = phase ? logn : n1_log;
    int s = phase ? n1_log : 0;
    while (s < end) {
      const int m = 1 << s;
      if (G == 2 && s + 1 < end) {
        const int lt2 = logn - 2 - s;  // quarter = 2^lt2
        const int t2 = 1 << lt2;
        for (int j = threadIdx.x; j < (n >> 2); j += blockDim.x) {
          const int g = j >> lt2;
          const int c0 = (g << (lt2 + 2)) | (j & (t2 - 1));
          T x0 = a[c0], x1 = a[c0 + t2], x2 = a[c0 + 2 * t2], x3 = a[c0 + 3 * t2];
          const T wa = __ldg(w + m + g), wca = Red::kCon ? __ldg(w_con + m + g) : (T)0;
          fwd_bfly<T, Red>(x0, x2, wa, wca, q, red);
          fwd_bfly<T, Red>(x1, x3, wa, wca, q, red);
          const int b = 2 * (m + g);
          fwd_bfly<T, Red>(x0, x1, __ldg(w + b), Red::kCon ? __ldg(w_con + b) : (T)0, q,
                           red);
          fwd_bfly<T, Red>(x2, x3, __ldg(w + b + 1), Red::kCon ? __ldg(w_con + b + 1) : (T)0,
                           q, red);
          a[c0] = x0;
          a[c0 + t2] = x1;
          a[c0 + 2 * t2] = x2;
          a[c0 + 3 * t2] = x3;
        }
        s += 2;
      } else {
        const int lt = logn - 1 - s;
        for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
          const StageIndex ix(j, lt);
          T x = a[ix.i0];
          T y = a[ix.i1];
          fwd_bfly<T, Red>(x, y, __ldg(w + m + ix.g),
                           Red::kCon ? __ldg(w_con + m + ix.g) : (T)0, q, red);
          a[ix.i0] = x;
          a[ix.i1] = y;
        }
        s += 1;
      }
      __syncthreads();
    }
  }
  store_poly<T>(a, out + base, q, logn, n1_log, strict, keep_t);
}

// Pairs a thread of L2 holds in registers: N/2 / threads at the largest N a
// block takes (2^15 words of 4 bytes, 2^14 of 8), i.e. 64 bytes of words.
template <typename T>
constexpr int kPairs = 64 / sizeof(T);

// Pair p of Stockham stage s (s counted within its phase): the slots it reads
// (x, x + dy), its twiddle index, and the slots it writes (o, o + dz).  Column
// phase: p = i * N2 + c pairs rows i and i + N1/2 of column c and writes rows
// 2i and 2i + 1.  Row phase: p = c * N2/2 + i pairs words i and i + N2/2 of
// row c and writes words 2i and 2i + 1.
struct StockhamPair {
  int x, dy, widx, o, dz;
  __device__ __forceinline__ StockhamPair(int p, int s, bool col, int logn, int n1_log) {
    const int n2_log = logn - n1_log;
    const int low = (1 << s) - 1;
    if (col) {
      const int i = p >> n2_log;
      x = p;
      dy = 1 << (logn - 1);
      widx = (1 << s) + (i & low);
      o = p + (i << n2_log);  // (2i, c)
      dz = 1 << n2_log;
    } else {
      const int c = p >> (n2_log - 1);
      const int i = p & ((1 << (n2_log - 1)) - 1);
      x = (c << n2_log) + i;
      dy = 1 << (n2_log - 1);
      widx = (1 << (n1_log + s)) + (c << s) + (i & low);
      o = (c << n2_log) + 2 * i;
      dz = 1;
    }
  }
};

template <typename T, class Red>
__global__ void __launch_bounds__(kMaxThreads)
fwd_v3_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
              const T* __restrict__ w_con, T q, int logn, int n1_log, int strict,
              int keep_t, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t base = (size_t)blockIdx.x << logn;
  load_poly<T>(a, in + base, n);

  for (int st = 0; st < logn; ++st) {
    const bool col = st < n1_log;
    const int s = col ? st : st - n1_log;
    T xs[kPairs<T>], ys[kPairs<T>];
#pragma unroll
    for (int k = 0; k < kPairs<T>; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < half) {
        const StockhamPair sp(p, s, col, logn, n1_log);
        T x = a[sp.x];
        T y = a[sp.x + sp.dy];
        fwd_bfly<T, Red>(x, y, __ldg(w + sp.widx), Red::kCon ? __ldg(w_con + sp.widx) : (T)0,
                         q, red);
        xs[k] = x;
        ys[k] = y;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairs<T>; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < half) {
        const StockhamPair sp(p, s, col, logn, n1_log);
        a[sp.o] = xs[k];
        a[sp.o + sp.dz] = ys[k];
      }
    }
    __syncthreads();
  }
  store_poly<T>(a, out + base, q, logn, n1_log, strict, keep_t);
}

template <typename T, class Red = ShoupRed>
int launch_v2(const void* in, void* out, const void* w, const void* w_con, u64 q,
              int batch, int logn, int n1_log, int group, int strict, int keep_t,
              void* stream, Red red = Red()) {
  if (n1_log < 1 || n1_log > logn) return (int)cudaErrorInvalidValue;
  if (group != 1 && group != 2) return (int)cudaErrorInvalidValue;
  return launch_per_poly<T>(group == 1 ? fwd_v2_kernel<T, 1, Red> : fwd_v2_kernel<T, 2, Red>,
                            batch, logn, stream, (const T*)in, (T*)out, (const T*)w,
                            (const T*)w_con, (T)q, logn, n1_log, strict, keep_t, red);
}

template <typename T, class Red = ShoupRed>
int launch_v3(const void* in, void* out, const void* w, const void* w_con, u64 q,
              int batch, int logn, int n1_log, int strict, int keep_t, void* stream,
              Red red = Red()) {
  if (n1_log < 1 || n1_log > logn) return (int)cudaErrorInvalidValue;
  if (logn > 1 && (1 << (logn - 1)) > kPairs<T> * block_threads(logn))
    return (int)cudaErrorInvalidValue;  // more pairs than a thread holds
  return launch_per_poly<T>(fwd_v3_kernel<T, Red>, batch, logn, stream, (const T*)in,
                            (T*)out, (const T*)w, (const T*)w_con, (T)q, logn, n1_log,
                            strict, keep_t, red);
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
