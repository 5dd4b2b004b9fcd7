// The whole negacyclic NTT of one polynomial in one block, forward (K1) and
// inverse (K2), at word 32 (q < 2^30) and word 64 (q < 2^62).
//
// K1 rounds_kernel<T, ..., false> (rounds.cuh) replaces the Pallas kernel
// _fwd_kernel (ntt_tpu/kernels/pallas_fused.py:230); K2 rounds_kernel<T, ...,
// true> replaces _inv_kernel (:257), the whole inverse in one residency
// (the JAX word-64 inverse splits it into _inv_rows_kernel (:286) +
// _inv_cols_kernel (:307), which K6 / K7 of ntt_sixstep.cu port as separate
// launches).
//
// What bounds them on an H100: device memory sees each coefficient twice (one
// load, one store) plus the twiddle tables, which all blocks share and which
// stay resident in L2; each butterfly costs a Shoup multiply (two 64x64
// products at word 64).  Their first design ran log2 N radix-2 stages as
// passes over shared memory with a barrier after each (the lab's L1 at one
// stage a round, v2-r2, keeps that structure): at N = 2^14 those passes and
// barriers were a third of the time, one scalar load a thread and a separate
// store pass left device memory at 65 % of its rate, and every butterfly
// read its own twiddle pair.
//
// Design (rounds.cuh): each thread holds 16 coefficients in registers and
// runs four stages on them with no barrier; the block exchanges the
// polynomial through padded shared memory only between rounds (three
// exchanges at N = 2^14, where the first design had fourteen passes).  The
// forward's first round reads device memory straight into registers at
// stride N/16, coalesced, and its last round (stride 1) goes through shared
// memory once more so that the store is coalesced 16-byte writes; the
// inverse's first round reads 16 consecutive words a thread and its last
// round stores its fused final stage straight from registers, coalesced.  A
// thread reads each twiddle pair its round needs once, with 16-byte loads.
// Warps that have their words compute while later warps still load.  The
// design point (Fused<T>, rounds.cuh): 512 threads a block, two groups of
// 16 a thread at N = 2^14; at word 32 at most 64 registers a thread, so two
// blocks share an SM and one polynomial's loads overlap another's
// arithmetic; at word 64 the polynomial's 136 KB of shared memory allow one
// block an SM.  PERF.md's lever table holds what each choice was measured
// to cost against the others.  What bounds the design at word 64 is the
// butterflies (29 SASS instructions each, 57 for the fused final stage)
// against device memory at one block an SM: one polynomial's loads overlap
// only its own arithmetic.
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "rounds.cuh"

namespace ntt {

template <typename T>
int launch_fwd(const void* in, void* out, const void* w, const void* w_con, u64 q,
               int batch, int logn, int strict, void* stream) {
  return launch_rounds<T, false>(in, out, w, w_con, q, FinalConsts<T>{}, batch, logn, strict,
                                 stream);
}

template <typename T>
int launch_inv(const void* in, void* out, const void* w, const void* w_con, u64 q,
               u64 n_inv, u64 n_inv_con, u64 f_tmp, u64 f_con_lo, int f_con_hi, int batch,
               int logn, void* stream) {
  FinalConsts<T> fc;
  fc.n_inv = (T)n_inv;
  fc.n_inv_con = (T)n_inv_con;
  fc.tmp = (T)f_tmp;
  fc.con_lo = (T)f_con_lo;
  fc.con_hi = f_con_hi;
  return launch_rounds<T, true>(in, out, w, w_con, q, fc, batch, logn, 0, stream);
}

}  // namespace ntt

// Plain C interface, loaded with ctypes by ntt_tpu_torch/native.py.  Each
// launcher enqueues one launch on `stream` (batch blocks of one polynomial
// each, N = 2^logn) and returns the cudaError_t of the launch; a nonzero
// value means the kernel never ran.
extern "C" {

const char* ntt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int ntt_fwd_fused_u32(const void* in, void* out, const void* w, const void* w_con,
                      unsigned long long q, int batch, int logn, int strict,
                      void* stream) {
  return ntt::launch_fwd<ntt::u32>(in, out, w, w_con, q, batch, logn, strict, stream);
}

int ntt_fwd_fused_u64(const void* in, void* out, const void* w, const void* w_con,
                      unsigned long long q, int batch, int logn, int strict,
                      void* stream) {
  return ntt::launch_fwd<ntt::u64>(in, out, w, w_con, q, batch, logn, strict, stream);
}

int ntt_inv_fused_u32(const void* in, void* out, const void* w, const void* w_con,
                      unsigned long long q, unsigned long long n_inv,
                      unsigned long long n_inv_con, unsigned long long f_tmp,
                      unsigned long long f_con_lo, int f_con_hi, int batch,
                      int logn, void* stream) {
  return ntt::launch_inv<ntt::u32>(in, out, w, w_con, q, n_inv, n_inv_con, f_tmp,
                                   f_con_lo, f_con_hi, batch, logn, stream);
}

int ntt_inv_fused_u64(const void* in, void* out, const void* w, const void* w_con,
                      unsigned long long q, unsigned long long n_inv,
                      unsigned long long n_inv_con, unsigned long long f_tmp,
                      unsigned long long f_con_lo, int f_con_hi, int batch,
                      int logn, void* stream) {
  return ntt::launch_inv<ntt::u64>(in, out, w, w_con, q, n_inv, n_inv_con, f_tmp,
                                   f_con_lo, f_con_hi, batch, logn, stream);
}

}  // extern "C"
