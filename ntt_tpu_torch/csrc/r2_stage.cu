// K9: one radix-2 Harvey stage of a batch of negacyclic NTTs, at word 32 and
// word 64 -- the stage kernel of the reference's radix-2 families ('radix2',
// 'radix2-u32', 'seal', 'hexl', 'r2-16') and of the radix-2 tail of 'r4r2'.
//
// Replaces the JAX package's jnp stages (ntt_tpu/kernels/radix2.py:65, :99,
// :192, :210, :307, :343, :365 and mixed.py's tail), which XLA fused a stage
// at a time on the TPU.  Its plain version is ntt_tpu_torch/kernels/radix2.py's
// plain_stage; the stage descriptor is that module's R2Stage.
//
// A stage of N = 2^logn words pairs word i0 with i0 + t, t = 2^lt, in groups of
// 2t; group g reads its twiddle at base + perm(g) * gs + j * js, j < t its
// butterfly in the group, which covers the bit-reversed table (base m, gs 1,
// js 0), the duplicated segments of the HEXL / r2_16 / r4r2 layouts (gs 4 or
// 2, js 1) and their lane-permuted ones (perm).  Modes: the forward butterfly,
// the backward one, the fused n^-1 final stage and SEAL's final stage; pre
// reduces both inputs 8q -> 4q; post reduces the outputs 4q -> q or scales
// them by n^-1, strict.
//
// What bounds it on an H100: device memory.  Each stage reads and writes every
// word once (16 bytes a butterfly at word 64) for one Shoup product (10 32-bit
// multiplies at word 64, 3 at word 32), well below the card's ratio of
// operations to bytes.  Design, simple first: one launch a stage, one thread a
// butterfly in a grid-stride loop; neighbouring threads take neighbouring
// butterflies, so the loads of x and of y are each coalesced wherever t >= 32
// and a warp's twiddle reads fall on one or a few entries (read through the
// read-only cache).  A transform costs log2 N passes over device memory where
// K1 costs one; holding it on chip across stages is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt {

constexpr int kR2Threads = 256;

enum R2Mode { kR2Fwd = 0, kR2Bkw = 1, kR2Final = 2, kR2SealFinal = 3 };
enum R2Post { kR2PostNone = 0, kR2Post4qToQ = 1, kR2PostNinv = 2 };

template <typename T>
struct R2Args {
  long long count;  // butterflies: rows * N / 2
  long long base;
  int logn, lt, mode, pre, post, gs, js, perm;
  T q;
  FinalConsts<T> f;
};

// The lane orders of the r2_16 / r4r2 tail segments: perm 1 reads group
// (g & ~7) | T1_INV[g & 7], T1_INV = argsort(LANE_PERM) = {0,2,4,6,1,3,5,7};
// perm 2 reads (g & ~3) | T2_INV[g & 3], T2_INV = {0,2,1,3}.
__device__ __forceinline__ int tail_group(int g, int perm) {
  if (perm == 1) {
    const int j = g & 7;
    return (g & ~7) | (j < 4 ? 2 * j : 2 * (j - 4) + 1);
  }
  if (perm == 2) {
    const int j = g & 3;
    return (g & ~3) | (j == 1 ? 2 : j == 2 ? 1 : j);
  }
  return g;
}

// SEAL's final inverse stage (ntt_tpu/kernels/radix2.py:210-268): u = guard(x);
// x' = n_inv * guard(u + y), without the lazy reduction; y' = scaled_r *
// (u + 2q - y), scaled_r = n_inv * w_inv[1] with its possibly wide constant;
// then both 2q -> q.
template <typename T>
__device__ __forceinline__ void seal_final(T& x, T& y, const FinalConsts<T>& f, T q) {
  const T u = cond_sub<T>(x, (T)(2 * q));
  const T s = cond_sub<T>((T)(u + y), (T)(2 * q));
  const T nx = shoup_mul_q2<T>(f.n_inv, f.n_inv_con, s, q);
  const T d = (T)(u + 2 * q - y);
  T big_q = mulhi(f.con_lo, d);
  if (f.con_hi) big_q = (T)(big_q + d);
  x = reduce_2q_to_q<T>(nx, q);
  y = reduce_2q_to_q<T>((T)(f.tmp * d - big_q * q), q);
}

template <typename T>
__global__ void __launch_bounds__(kR2Threads)
r2_stage_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ tab,
                const T* __restrict__ con, R2Args<T> s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int half_log = s.logn - 1;
  const int t_mask = (1 << s.lt) - 1;
  const T q = s.q;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < s.count;
       i += stride) {
    const long long off = (i >> half_log) << s.logn;
    const int j = (int)(i & ((1ll << half_log) - 1));
    const StageIndex ix(j, s.lt);
    T x = in[off + ix.i0];
    T y = in[off + ix.i1];
    if (s.pre) {
      x = cond_sub<T>(x, (T)(4 * q));
      y = cond_sub<T>(y, (T)(4 * q));
    }
    if (s.mode == kR2Fwd || s.mode == kR2Bkw) {
      const long long k = s.base + (long long)tail_group(ix.g, s.perm) * s.gs +
                          (long long)(j & t_mask) * s.js;
      const T w = __ldg(tab + k), wc = __ldg(con + k);
      if (s.mode == kR2Fwd) {
        fwd_bfly<T>(x, y, w, wc, q);
      } else {
        bkw_bfly<T>(x, y, w, wc, q);
      }
    } else if (s.mode == kR2Final) {
      bkw_final<T>(x, y, s.f, q);
    } else {
      seal_final<T>(x, y, s.f, q);
    }
    if (s.post == kR2Post4qToQ) {
      x = reduce_4q_to_q<T>(x, q);
      y = reduce_4q_to_q<T>(y, q);
    } else if (s.post == kR2PostNinv) {
      x = reduce_2q_to_q<T>(shoup_mul_q2<T>(s.f.n_inv, s.f.n_inv_con, x, q), q);
      y = reduce_2q_to_q<T>(shoup_mul_q2<T>(s.f.n_inv, s.f.n_inv_con, y, q), q);
    }
    out[off + ix.i0] = x;
    out[off + ix.i1] = y;
  }
}

template <typename T>
int launch_r2_stage(const void* in, void* out, const void* tab, const void* con,
                    unsigned long long q, long long rows, int logn, int lt, int mode, int pre,
                    int post, long long base, int gs, int js, int perm, unsigned long long n_inv,
                    unsigned long long n_inv_con, unsigned long long f_tmp,
                    unsigned long long f_con_lo, int f_con_hi, void* stream) {
  if (rows < 1 || logn < 1 || logn > 30 || lt < 0 || lt >= logn || mode < 0 || mode > 3 ||
      pre < 0 || pre > 1 || post < 0 || post > 2 || perm < 0 || perm > 2 || base < 0 ||
      gs < 0 || js < 0 || ((mode == kR2Final || mode == kR2SealFinal) && lt != logn - 1))
    return (int)cudaErrorInvalidValue;
  R2Args<T> s;
  s.count = rows << (logn - 1);
  s.base = base;
  s.logn = logn;
  s.lt = lt;
  s.mode = mode;
  s.pre = pre;
  s.post = post;
  s.gs = gs;
  s.js = js;
  s.perm = perm;
  s.q = (T)q;
  s.f.n_inv = (T)n_inv;
  s.f.n_inv_con = (T)n_inv_con;
  s.f.tmp = (T)f_tmp;
  s.f.con_lo = (T)f_con_lo;
  s.f.con_hi = f_con_hi;
  long long blocks = (s.count + kR2Threads - 1) / kR2Threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  r2_stage_kernel<T><<<(unsigned)blocks, kR2Threads, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)tab, (const T*)con, s);
  return (int)cudaGetLastError();
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu): in and out (rows, N), the twiddle table
// and its Shoup constants at the entry point's word; f_con_hi is the top bit of
// the final stage's constant.
extern "C" {

int ntt_r2_stage_u32(const void* in, void* out, const void* tab, const void* con,
                     unsigned long long q, long long rows, int logn, int lt, int mode, int pre,
                     int post, long long base, int gs, int js, int perm,
                     unsigned long long n_inv, unsigned long long n_inv_con,
                     unsigned long long f_tmp, unsigned long long f_con_lo, int f_con_hi,
                     void* stream) {
  return ntt::launch_r2_stage<ntt::u32>(in, out, tab, con, q, rows, logn, lt, mode, pre, post,
                                        base, gs, js, perm, n_inv, n_inv_con, f_tmp, f_con_lo,
                                        f_con_hi, stream);
}

int ntt_r2_stage_u64(const void* in, void* out, const void* tab, const void* con,
                     unsigned long long q, long long rows, int logn, int lt, int mode, int pre,
                     int post, long long base, int gs, int js, int perm,
                     unsigned long long n_inv, unsigned long long n_inv_con,
                     unsigned long long f_tmp, unsigned long long f_con_lo, int f_con_hi,
                     void* stream) {
  return ntt::launch_r2_stage<ntt::u64>(in, out, tab, con, q, rows, logn, lt, mode, pre, post,
                                        base, gs, js, perm, n_inv, n_inv_con, f_tmp, f_con_lo,
                                        f_con_hi, stream);
}

}  // extern "C"
