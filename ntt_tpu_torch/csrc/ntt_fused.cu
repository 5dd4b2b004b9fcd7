// The whole negacyclic NTT of one polynomial held in shared memory, forward
// (K1) and inverse (K2), at word 32 (q < 2^30) and word 64 (q < 2^62).
//
// K1 fwd_fused_kernel replaces the Pallas kernel _fwd_kernel
// (ntt_tpu/kernels/pallas_fused.py:230); K2 inv_fused_kernel replaces
// _inv_kernel (:257), the whole inverse in one residency (the JAX word-64
// inverse splits it into _inv_rows_kernel (:286) + _inv_cols_kernel (:307),
// which K6 / K7 of ntt_sixstep.cu port as separate launches).
//
// What bounds them on an H100: each butterfly stage reads and writes all N
// coefficients of shared memory once and needs a block-wide barrier, and each
// butterfly costs a Shoup multiply (two 64x64 products at word 64).  Device
// memory sees each coefficient twice (one load, one store) plus the twiddle
// tables, which all blocks share and which stay resident in L2 (2 x N words).
// At N = 2^14 and word 64 the polynomial is 128 KB: one block per SM.
//
// Design: one block per polynomial; the N coefficients are loaded once into
// dynamic shared memory, all log2 N radix-2 stages run there with one
// __syncthreads() between stages, and the result is stored once.  The
// Pallas kernels' pre-broadcast (stage, rows, lanes) twiddle stacks exist
// only because Mosaic cannot reshape across lanes; here every butterfly
// reads w[m + g] / w_con[m + g] straight from the flat N-entry tables.  The
// flat Harvey stages give the same bits as the six-step phases of the plain
// version (kernels/sixstep.py) and of the Pallas kernels: every coefficient
// meets the same butterflies with the same twiddles.
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "poly_block.cuh"

namespace ntt {

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fwd_fused_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const T* __restrict__ w, const T* __restrict__ w_con, T q,
                 int logn, int strict) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t base = (size_t)blockIdx.x << logn;

  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = in[base + i];
  __syncthreads();

  for (int s = 0; s < logn; ++s) {
    const int m = 1 << s;
    const int lt = logn - 1 - s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const StageIndex ix(j, lt);
      T x = a[ix.i0];
      T y = a[ix.i1];
      fwd_bfly<T>(x, y, __ldg(w + m + ix.g), __ldg(w_con + m + ix.g), q);
      a[ix.i0] = x;
      a[ix.i1] = y;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = a[i];
    out[base + i] = strict ? reduce_4q_to_q<T>(v, q) : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
inv_fused_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const T* __restrict__ w, const T* __restrict__ w_con, T q,
                 FinalConsts<T> fc, int logn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t base = (size_t)blockIdx.x << logn;

  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = in[base + i];
  __syncthreads();

  // Gentleman-Sande stages m = N/2 .. 2 (t = 1 .. N/4)
  for (int s = logn - 1; s >= 1; --s) {
    const int m = 1 << s;
    const int lt = logn - 1 - s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const StageIndex ix(j, lt);
      T x = a[ix.i0];
      T y = a[ix.i1];
      bkw_bfly<T>(x, y, __ldg(w + m + ix.g), __ldg(w_con + m + ix.g), q);
      a[ix.i0] = x;
      a[ix.i1] = y;
    }
    __syncthreads();
  }

  // fused final stage (t = N/2), stored straight to device memory
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    T x = a[j];
    T y = a[j + half];
    bkw_final<T>(x, y, fc, q);
    out[base + j] = x;
    out[base + j + half] = y;
  }
}

template <typename T>
int launch_fwd(const void* in, void* out, const void* w, const void* w_con,
               u64 q, int batch, int logn, int strict, void* stream) {
  return launch_per_poly<T>(fwd_fused_kernel<T>, batch, logn, stream, (const T*)in,
                            (T*)out, (const T*)w, (const T*)w_con, (T)q, logn, strict);
}

template <typename T>
int launch_inv(const void* in, void* out, const void* w, const void* w_con,
               u64 q, u64 n_inv, u64 n_inv_con, u64 f_tmp, u64 f_con_lo,
               int f_con_hi, int batch, int logn, void* stream) {
  FinalConsts<T> fc;
  fc.n_inv = (T)n_inv;
  fc.n_inv_con = (T)n_inv_con;
  fc.tmp = (T)f_tmp;
  fc.con_lo = (T)f_con_lo;
  fc.con_hi = f_con_hi;
  return launch_per_poly<T>(inv_fused_kernel<T>, batch, logn, stream, (const T*)in,
                            (T*)out, (const T*)w, (const T*)w_con, (T)q, fc, logn);
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
