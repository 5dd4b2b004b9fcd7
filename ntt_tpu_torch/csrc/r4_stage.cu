// K10: one radix-4 five-twiddle stage (or one of the radix-2 sweeps that go
// with it) of a batch of negacyclic NTTs, at Shoup word 32, 56 and 64 -- the
// stage kernel of 'radix4', 'radix4-u32', 'radix4-w56', 'radix4-vec',
// 'radix4-vec-unordered' and of the radix-4 sweeps of 'r4r2'.
//
// Replaces the JAX package's jnp stages (ntt_tpu/kernels/radix4.py:95, :151,
// :174, :294, :353, :469, :501; mixed.py:55, :151, :215), fused a stage at a
// time by XLA on the TPU.  Its plain version is ntt_tpu_torch/kernels/radix4.py's
// plain_stage; the stage descriptor is that module's R4Stage.
//
// A radix-4 stage has m groups of 4t words, t = 2^lt (x, y, z, t at offsets 0,
// t, 2t, 3t); group g reads its five twiddles from the 2N expand_w table
// (tw 0: m1 = 2(m + g), entries m1, 2m1, 2m1 + 1, 2m1 + 2, 2m1 + 3) or from a
// region of a 5N layout in blocks of 2^L groups (tw 1: base + (g >> L) * 5 *
// 2^L + k * 2^L + (g & (2^L - 1)), L = step).  The butterflies are the
// reference's (ntt_tpu/kernels/radix4.py:57-93), their y-products one dual
// Shoup product each (Word<W>::dbl).  At t == 1 a stage may read its groups in
// LANE_PERM order within blocks of 8 (perm 1, the unordered forward) or write
// them so (perm 2, the unordered inverse).  A radix-2 sweep (modes 2, 3) pairs
// (i0, i0 + t) and reads its twiddle at base + g * step.  pre reduces all four
// inputs 8q -> 2q (1) or x alone 8q -> 4q (2); post reduces the outputs
// 8q -> q (1) or scales them by n^-1, strict (2).
//
// What bounds it on an H100: device memory at word 32; at word 64 the
// multiplies come close.  A radix-4 stage reads and writes every word once for
// two butterfly layers (32 bytes a group of four at word 64) and does one
// Shoup product and two dual ones a group, about 50 32-bit multiplies at word
// 64.  Design, simple first: one launch a stage, one thread a group of four
// words in a grid-stride loop, neighbouring threads on neighbouring j within a
// group (coalesced wherever t >= 32), the five twiddle pairs read through the
// read-only cache.  Holding a transform on chip across stages is later work.
// Under the NTT_MULMOD=solinas switch the single products at words 32 and 64
// (w0's, the radix-2 sweeps', the n^-1 scale) take the Solinas form, the
// SolinasRed instantiation of modarith.cuh, which reads no Shoup constant for
// them; the dual products and word 56 stay Shoup, as in the JAX package.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt {

constexpr int kR4Threads = 256;

enum R4Mode { kR4Fwd = 0, kR4Inv = 1, kR2SweepFwd = 2, kR2SweepBkw = 3 };

template <typename T>
struct R4Args {
  long long count;  // threads: rows * N / 4 (radix-4) or rows * N / 2 (radix-2)
  long long base;
  int logn, lt, mode, pre, post, tw, step, perm;
  T q, n_inv, n_inv_con;
};

// LANE_PERM = {0, 4, 1, 5, 2, 6, 3, 7} within a block of 8 groups.
__device__ __forceinline__ long long lane_perm(long long g) {
  const int j = (int)(g & 7);
  return (g & ~7ll) | ((j & 1) ? 4 + (j >> 1) : (j >> 1));
}

// The single product: Red's at words 32 and 64, Shoup's at word 56 always.
template <int W, class Red>
__device__ __forceinline__ typename Word<W>::T mul1(Red red, typename Word<W>::T w,
                                                    typename Word<W>::T c,
                                                    typename Word<W>::T t,
                                                    typename Word<W>::T q) {
  if constexpr (W == 56) {
    return Word<W>::mul(w, c, t, q);
  } else {
    return red.mul(w, c, t, q);
  }
}

template <int W, class Red>
__device__ __forceinline__ void r4_fwd(typename Word<W>::T v[4], const typename Word<W>::T w[5],
                                       const typename Word<W>::T c[5], typename Word<W>::T q,
                                       Red red) {
  typedef typename Word<W>::T T;
  const T y1 = Word<W>::dbl(w[1], c[1], w[2], c[2], v[1], v[3], q);
  const T y2 = Word<W>::dbl(w[3], c[3], w[4], c[4], v[1], v[3], q);
  const T t1 = cond_sub<T>(v[0], (T)(4 * q));
  const T t2 = mul1<W>(red, w[0], c[0], v[2], q);
  const T s = (T)(t1 + t2), d = (T)(t1 - t2);
  v[0] = (T)(s + y1);
  v[1] = (T)(s + 2 * q - y1);
  v[2] = (T)(d + 2 * q + y2);
  v[3] = (T)(d + 4 * q - y2);
}

template <int W, class Red>
__device__ __forceinline__ void r4_inv(typename Word<W>::T v[4], const typename Word<W>::T w[5],
                                       const typename Word<W>::T c[5], typename Word<W>::T q,
                                       Red red) {
  typedef typename Word<W>::T T;
  const T t0 = (T)(v[2] + v[3]), t1 = (T)(v[0] + v[1]);
  const T t2 = (T)(v[0] + 4 * q - v[1]), t3 = (T)(v[2] + 4 * q - v[3]);
  v[0] = reduce_4q_to_2q<T>(cond_sub<T>((T)(t1 + t0), (T)(4 * q)), q);
  v[2] = reduce_2q_to_q<T>(mul1<W>(red, w[0], c[0], (T)(t1 + 4 * q - t0), q), q);
  v[1] = Word<W>::dbl(w[1], c[1], w[3], c[3], t2, t3, q);
  v[3] = Word<W>::dbl(w[2], c[2], w[4], c[4], t2, t3, q);
}

template <int W, class Red>
__device__ __forceinline__ typename Word<W>::T r4_post(typename Word<W>::T v,
                                                       const R4Args<typename Word<W>::T>& s,
                                                       Red red) {
  typedef typename Word<W>::T T;
  if (s.post == 1) return reduce_2q_to_q<T>(reduce_4q_to_2q<T>(cond_sub<T>(v, (T)(4 * s.q)), s.q),
                                            s.q);
  if (s.post == 2) return reduce_2q_to_q<T>(mul1<W>(red, s.n_inv, s.n_inv_con, v, s.q), s.q);
  return v;
}

template <int W, class Red>
__global__ void __launch_bounds__(kR4Threads)
r4_stage_kernel(const typename Word<W>::T* __restrict__ in, typename Word<W>::T* __restrict__ out,
                const typename Word<W>::T* __restrict__ tab,
                const typename Word<W>::T* __restrict__ con, R4Args<typename Word<W>::T> s,
                Red red) {
  typedef typename Word<W>::T T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool radix4 = s.mode == kR4Fwd || s.mode == kR4Inv;
  const int per_log = s.logn - (radix4 ? 2 : 1);  // threads a polynomial, log2
  const long long t_mask = (1ll << s.lt) - 1;
  const T q = s.q;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < s.count;
       i += stride) {
    const long long off = (i >> per_log) << s.logn;
    const long long j = i & ((1ll << per_log) - 1);
    const long long g = j >> s.lt, jj = j & t_mask;
    if (!radix4) {
      const long long i0 = off + (g << (s.lt + 1)) + jj, i1 = i0 + (1ll << s.lt);
      T x = in[i0];
      const T y = in[i1];
      if (s.pre == 2) x = cond_sub<T>(x, (T)(4 * q));
      const long long k = s.base + g * s.step;
      const T w = __ldg(tab + k), wc = Red::kCon ? __ldg(con + k) : 0;
      T nx, ny;
      if (s.mode == kR2SweepFwd) {
        const T x1 = reduce_4q_to_2q<T>(x, q);
        const T tt = mul1<W>(red, w, wc, y, q);
        nx = (T)(x1 + tt);
        ny = (T)(x1 + 2 * q - tt);
      } else {
        nx = reduce_4q_to_2q<T>((T)(x + y), q);
        ny = mul1<W>(red, w, wc, (T)(x + 2 * q - y), q);
      }
      out[i0] = r4_post<W>(nx, s, red);
      out[i1] = r4_post<W>(ny, s, red);
      continue;
    }
    const long long g_in = s.perm == 1 ? lane_perm(g) : g;
    const long long g_out = s.perm == 2 ? lane_perm(g) : g;
    const long long src = off + (g_in << (s.lt + 2)) + jj;
    const long long dst = off + (g_out << (s.lt + 2)) + jj;
    T v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = in[src + ((long long)k << s.lt)];
      if (s.pre == 1) v[k] = reduce_4q_to_2q<T>(cond_sub<T>(v[k], (T)(4 * q)), q);
    }
    long long idx[5];
    if (s.tw == 0) {
      const long long m1 = 2 * ((1ll << (s.logn - 2 - s.lt)) + g);
      idx[0] = m1;
      idx[1] = 2 * m1;
      idx[2] = 2 * m1 + 1;
      idx[3] = 2 * m1 + 2;
      idx[4] = 2 * m1 + 3;
    } else {
      const long long lane = 1ll << s.step;
      const long long b = s.base + (g >> s.step) * 5 * lane + (g & (lane - 1));
#pragma unroll
      for (int k = 0; k < 5; ++k) idx[k] = b + k * lane;
    }
    T w[5], c[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      w[k] = __ldg(tab + idx[k]);
      c[k] = (k > 0 || Red::kCon) ? __ldg(con + idx[k]) : 0;  // w0's: a single product
    }
    if (s.mode == kR4Fwd) {
      r4_fwd<W>(v, w, c, q, red);
    } else {
      r4_inv<W>(v, w, c, q, red);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[dst + ((long long)k << s.lt)] = r4_post<W>(v[k], s, red);
  }
}

template <int W, class Red = ShoupRed>
int launch_r4_stage(const void* in, void* out, const void* tab, const void* con,
                    unsigned long long q, long long rows, int logn, int lt, int mode, int pre,
                    int post, int tw, long long base, int step, int perm,
                    unsigned long long n_inv, unsigned long long n_inv_con, void* stream,
                    Red red = Red()) {
  typedef typename Word<W>::T T;
  const bool radix4 = mode == kR4Fwd || mode == kR4Inv;
  const int per_log = logn - (radix4 ? 2 : 1);
  if (rows < 1 || logn < 1 || logn > 30 || mode < 0 || mode > 3 || lt < 0 ||
      lt > per_log || per_log < 0 || pre < 0 || pre > 2 || post < 0 || post > 2 || tw < 0 ||
      tw > 1 || base < 0 || step < 0 || step > 3 + 30 * !radix4 || perm < 0 || perm > 2 ||
      (perm && (!radix4 || lt != 0 || logn < 5)))
    return (int)cudaErrorInvalidValue;
  R4Args<T> s;
  s.count = rows << per_log;
  s.base = base;
  s.logn = logn;
  s.lt = lt;
  s.mode = mode;
  s.pre = pre;
  s.post = post;
  s.tw = tw;
  s.step = step;
  s.perm = perm;
  s.q = (T)q;
  s.n_inv = (T)n_inv;
  s.n_inv_con = (T)n_inv_con;
  long long blocks = (s.count + kR4Threads - 1) / kR4Threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  r4_stage_kernel<W, Red><<<(unsigned)blocks, kR4Threads, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)tab, (const T*)con, s, red);
  return (int)cudaGetLastError();
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu): in and out (rows, N), the twiddle table
// and its Shoup constants at the entry point's word (int32 storage at word 32,
// int64 at words 64 and 56).
extern "C" {

#define NTT_R4_STAGE_ENTRY(name, W)                                                          \
  int name(const void* in, void* out, const void* tab, const void* con, unsigned long long q, \
           long long rows, int logn, int lt, int mode, int pre, int post, int tw,            \
           long long base, int step, int perm, unsigned long long n_inv,                     \
           unsigned long long n_inv_con, void* stream) {                                     \
    return ntt::launch_r4_stage<W>(in, out, tab, con, q, rows, logn, lt, mode, pre, post, tw, \
                                   base, step, perm, n_inv, n_inv_con, stream);              \
  }

NTT_R4_STAGE_ENTRY(ntt_r4_stage_u32, 32)
NTT_R4_STAGE_ENTRY(ntt_r4_stage_u64, 64)
NTT_R4_STAGE_ENTRY(ntt_r4_stage_w56, 56)

#undef NTT_R4_STAGE_ENTRY

// The SolinasRed instantiations at words 32 and 64: (e, k) before the
// stream; con is still read, for the dual products.
#define NTT_R4_STAGE_SOLINAS(name, W)                                                        \
  int name(const void* in, void* out, const void* tab, const void* con, unsigned long long q, \
           long long rows, int logn, int lt, int mode, int pre, int post, int tw,            \
           long long base, int step, int perm, unsigned long long n_inv,                     \
           unsigned long long n_inv_con, int e, int k, void* stream) {                       \
    return ntt::launch_r4_stage<W>(in, out, tab, con, q, rows, logn, lt, mode, pre, post, tw, \
                                   base, step, perm, n_inv, n_inv_con, stream,               \
                                   ntt::SolinasRed{e, k});                                   \
  }

NTT_R4_STAGE_SOLINAS(ntt_r4_stage_solinas_u32, 32)
NTT_R4_STAGE_SOLINAS(ntt_r4_stage_solinas_u64, 64)

#undef NTT_R4_STAGE_SOLINAS

}  // extern "C"
