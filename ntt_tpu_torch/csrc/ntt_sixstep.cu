// The two-pass six-step negacyclic NTT for N beyond one block's shared
// memory: four kernels, each one pass over device memory, at word 32
// (q < 2^30) and word 64 (q < 2^62).
//
// The coefficients of a polynomial are viewed as an (N1, N2) matrix, row
// major, N = N1 * N2.  The first log2 N1 Harvey stages are column NTTs with
// the twiddle w[m + g] of the flat table, the same for every column; the
// last log2 N2 stages are row NTTs in which row r, at row stage s' with
// m2 = 2^s' groups, reads w[m2*N1 + r*m2 + g].  So every coefficient meets
// the butterflies of the flat radix-2 transform and the result is bit for
// bit that of K1 / K2 and of the plain version (kernels/sixstep.py).
//
//   K4 fwd_cols_kernel  ntt_tpu/kernels/sixstep.py:259 fwd_phase1 (XLA code in
//                       JAX): the column stages; (N1, N2) in and out, < 4q.
//   K5 fwd_rows_kernel  sixstep.py:294 fwd_phase2 with the transposes of
//                       fwd_sixstep: the row stages, the strict 4q -> q
//                       reduce on the store; (N1, N2) in, (N1, N2) out or,
//                       keeping the transposed layout, (N2, N1).
//   K6 inv_rows_kernel  ntt_tpu/kernels/pallas_fused.py:286 _inv_rows_kernel
//                       (sixstep.py:339 inv_phaseA): the reversed row stages;
//                       (N1, N2) in or, from the transposed layout, (N2, N1);
//                       (N1, N2) out.
//   K7 inv_cols_kernel  pallas_fused.py:307 _inv_cols_kernel (sixstep.py:373
//                       inv_phaseB): the reversed column stages m = N1/2 .. 2
//                       and the fused n^-1 stage; (N1, N2) in, strict
//                       standard order out.
//
// The Pallas _inv_rows_kernel writes (N2, N1) for _inv_cols_kernel to read
// back; here the layout between K6 and K7 is (N1, N2), so K7 reads the same
// column tiles as K4 and only the two row kernels convert layouts.
//
// What bounds them on an H100: device memory.  Each pass reads and writes
// every coefficient once (a word-64 polynomial of N = 2^16 is 512 KB), and
// does log2 N1 or log2 N2 butterfly stages on it in shared memory; the
// integer multiplies of those stages take about half the time of the bytes at
// N = 2^16.  The row passes also read the row twiddles, about N words of w
// and N of w_con per pass: shared by the whole batch from L2, but at N = 2^24
// (two 128 MB tables against a 50 MB L2) a batch-1 pass reads more twiddle
// bytes than data.
//
// Design: one block per tile, the tile held in dynamic shared memory through
// all the pass's stages with one __syncthreads() between stages.
//   * Column passes: a tile is N1 rows x TC consecutive columns.  Each row
//     segment of TC words is one coalesced read, so TC is at least one 32-byte
//     sector's worth of words (4 at word 64, 8 at word 32), and grows while
//     the tile stays small (kernels/twopass.py picks it from N1 and the word).
//   * Row passes: a tile is TR consecutive rows of N2.  Rows are contiguous in
//     the (N1, N2) layout; in the (N2, N1) layout the TR rows of one column
//     are TR consecutive words, so TR is at least one sector's worth too, and
//     the tile's row pitch is padded so that the transposed accesses of a
//     warp fall in distinct shared-memory banks.
//   * Blocks are numbered batch-fastest, so the blocks running together on
//     the card work on the same rows of different polynomials and share the
//     row twiddles in L2.
// Element offsets into device memory are size_t: batch x N passes 2^31.
#include <climits>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace ntt {

constexpr int kTileThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a Hopper block can use

// Words between the starts of two rows of a row tile: N2 plus a pad that puts
// the TR rows of one column (the transposed accesses) in distinct banks.
__host__ __device__ inline int row_pitch(int n2_log, int tr_log, int word_bytes) {
  const int pad = 128 / (word_bytes << tr_log);
  return (1 << n2_log) + (pad > 1 ? pad : 1);
}

inline int tile_threads(int count) {
  const int half = count >> 1;
  return half < kTileThreads ? (half > 0 ? half : 1) : kTileThreads;
}

// ---------------------------------------------------------------------------
// column passes: tile (N1, TC) at columns [c0, c0 + TC) of one polynomial
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
fwd_cols_kernel(const T* __restrict__ in, T* __restrict__ out,
                const T* __restrict__ w, const T* __restrict__ w_con, T q,
                int batch, int n1_log, int n2_log, int tc_log) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tc = 1 << tc_log;
  const int count = 1 << (n1_log + tc_log);
  const size_t base = ((size_t)(blockIdx.x % batch) << (n1_log + n2_log)) +
                      ((size_t)(blockIdx.x / batch) << tc_log);

  for (int i = threadIdx.x; i < count; i += blockDim.x)
    s[i] = in[base + ((size_t)(i >> tc_log) << n2_log) + (i & (tc - 1))];
  __syncthreads();

  for (int st = 0; st < n1_log; ++st) {
    const int m = 1 << st;
    const int lt = n1_log - 1 - st;
    for (int j = threadIdx.x; j < (count >> 1); j += blockDim.x) {
      const int c = j & (tc - 1);
      const StageIndex ix(j >> tc_log, lt);
      T x = s[(ix.i0 << tc_log) + c];
      T y = s[(ix.i1 << tc_log) + c];
      fwd_bfly<T>(x, y, __ldg(w + m + ix.g), __ldg(w_con + m + ix.g), q);
      s[(ix.i0 << tc_log) + c] = x;
      s[(ix.i1 << tc_log) + c] = y;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += blockDim.x)
    out[base + ((size_t)(i >> tc_log) << n2_log) + (i & (tc - 1))] = s[i];
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
inv_cols_kernel(const T* __restrict__ in, T* __restrict__ out,
                const T* __restrict__ w, const T* __restrict__ w_con, T q,
                FinalConsts<T> fc, int batch, int n1_log, int n2_log, int tc_log) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tc = 1 << tc_log;
  const int count = 1 << (n1_log + tc_log);
  const size_t base = ((size_t)(blockIdx.x % batch) << (n1_log + n2_log)) +
                      ((size_t)(blockIdx.x / batch) << tc_log);

  for (int i = threadIdx.x; i < count; i += blockDim.x)
    s[i] = in[base + ((size_t)(i >> tc_log) << n2_log) + (i & (tc - 1))];
  __syncthreads();

  // Gentleman-Sande column stages m = N1/2 .. 2
  for (int st = n1_log - 1; st >= 1; --st) {
    const int m = 1 << st;
    const int lt = n1_log - 1 - st;
    for (int j = threadIdx.x; j < (count >> 1); j += blockDim.x) {
      const int c = j & (tc - 1);
      const StageIndex ix(j >> tc_log, lt);
      T x = s[(ix.i0 << tc_log) + c];
      T y = s[(ix.i1 << tc_log) + c];
      bkw_bfly<T>(x, y, __ldg(w + m + ix.g), __ldg(w_con + m + ix.g), q);
      s[(ix.i0 << tc_log) + c] = x;
      s[(ix.i1 << tc_log) + c] = y;
    }
    __syncthreads();
  }

  // fused final stage: row r pairs with row r + N1/2; stored straight to
  // device memory
  const int half_rows = 1 << (n1_log - 1);
  for (int j = threadIdx.x; j < (count >> 1); j += blockDim.x) {
    const int c = j & (tc - 1);
    const int r = j >> tc_log;
    T x = s[(r << tc_log) + c];
    T y = s[((r + half_rows) << tc_log) + c];
    bkw_final<T>(x, y, fc, q);
    out[base + ((size_t)r << n2_log) + c] = x;
    out[base + ((size_t)(r + half_rows) << n2_log) + c] = y;
  }
}

// ---------------------------------------------------------------------------
// row passes: tile of TR rows [r0, r0 + TR) of one polynomial, row pitch P
// ---------------------------------------------------------------------------

// Tile element (rr, k) <-> device memory, in the (N1, N2) layout (rows
// contiguous) or the (N2, N1) layout (element (r, k) at k*N1 + r).  With
// transposed, consecutive i walk the TR rows of one column: TR consecutive
// words of device memory.
struct RowTile {
  int n1_log, n2_log, tr_log, pitch;
  size_t poly;  // offset of the polynomial
  int r0;

  __device__ __forceinline__ size_t dev(int i, bool transposed, int& sm) const {
    if (transposed) {
      const int k = i >> tr_log;
      const int rr = i & ((1 << tr_log) - 1);
      sm = rr * pitch + k;
      return poly + ((size_t)k << n1_log) + r0 + rr;
    }
    const int rr = i >> n2_log;
    const int k = i & ((1 << n2_log) - 1);
    sm = rr * pitch + k;
    return poly + ((size_t)r0 << n2_log) + i;
  }
};

template <typename T>
__device__ __forceinline__ RowTile row_tile(int batch, int n1_log, int n2_log,
                                            int tr_log) {
  RowTile t;
  t.n1_log = n1_log;
  t.n2_log = n2_log;
  t.tr_log = tr_log;
  t.pitch = row_pitch(n2_log, tr_log, (int)sizeof(T));
  t.poly = (size_t)(blockIdx.x % batch) << (n1_log + n2_log);
  t.r0 = (int)(blockIdx.x / batch) << tr_log;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
fwd_rows_kernel(const T* __restrict__ in, T* __restrict__ out,
                const T* __restrict__ w, const T* __restrict__ w_con, T q,
                int batch, int n1_log, int n2_log, int tr_log, int strict,
                int out_transposed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const RowTile t = row_tile<T>(batch, n1_log, n2_log, tr_log);
  const int count = 1 << (n2_log + tr_log);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int sm;
    const size_t g = t.dev(i, false, sm);
    s[sm] = in[g];
  }
  __syncthreads();

  for (int st = 0; st < n2_log; ++st) {
    const int m2 = 1 << st;
    const int lt = n2_log - 1 - st;
    const size_t tw0 = ((size_t)m2 << n1_log) + (size_t)t.r0 * m2;
    for (int j = threadIdx.x; j < (count >> 1); j += blockDim.x) {
      const int rr = j >> (n2_log - 1);
      const StageIndex ix(j & ((1 << (n2_log - 1)) - 1), lt);
      const size_t k = tw0 + (size_t)rr * m2 + ix.g;
      T* row = s + rr * t.pitch;
      T x = row[ix.i0];
      T y = row[ix.i1];
      fwd_bfly<T>(x, y, __ldg(w + k), __ldg(w_con + k), q);
      row[ix.i0] = x;
      row[ix.i1] = y;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int sm;
    const size_t g = t.dev(i, out_transposed != 0, sm);
    const T v = s[sm];
    out[g] = strict ? reduce_4q_to_q<T>(v, q) : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
inv_rows_kernel(const T* __restrict__ in, T* __restrict__ out,
                const T* __restrict__ w, const T* __restrict__ w_con, T q,
                int batch, int n1_log, int n2_log, int tr_log, int in_transposed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const RowTile t = row_tile<T>(batch, n1_log, n2_log, tr_log);
  const int count = 1 << (n2_log + tr_log);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int sm;
    const size_t g = t.dev(i, in_transposed != 0, sm);
    s[sm] = in[g];
  }
  __syncthreads();

  // Gentleman-Sande row stages, global m = N/2 .. N1
  for (int st = n2_log - 1; st >= 0; --st) {
    const int m2 = 1 << st;
    const int lt = n2_log - 1 - st;
    const size_t tw0 = ((size_t)m2 << n1_log) + (size_t)t.r0 * m2;
    for (int j = threadIdx.x; j < (count >> 1); j += blockDim.x) {
      const int rr = j >> (n2_log - 1);
      const StageIndex ix(j & ((1 << (n2_log - 1)) - 1), lt);
      const size_t k = tw0 + (size_t)rr * m2 + ix.g;
      T* row = s + rr * t.pitch;
      T x = row[ix.i0];
      T y = row[ix.i1];
      bkw_bfly<T>(x, y, __ldg(w + k), __ldg(w_con + k), q);
      row[ix.i0] = x;
      row[ix.i1] = y;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int sm;
    const size_t g = t.dev(i, false, sm);
    out[g] = s[sm];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Blocks of a pass: batch x (tiles of one polynomial); 0 if the shapes are
// out of range.
inline long long pass_blocks(int batch, int n1_log, int n2_log, int tile_log,
                             int tile_axis_log) {
  if (batch < 1 || n1_log < 1 || n2_log < 0 || n1_log + n2_log > 30 ||
      tile_log < 0 || tile_log > tile_axis_log)
    return 0;
  const long long blocks = (long long)batch << (tile_axis_log - tile_log);
  return blocks <= INT_MAX ? blocks : 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch_fwd_cols(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tc_log,
                    void* stream) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tc_log, n2_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int count = 1 << (n1_log + tc_log);
  const size_t smem = sizeof(T) * count;
  cudaError_t err = prepare(fwd_cols_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_cols_kernel<T><<<(unsigned)blocks, tile_threads(count), smem,
                       (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q, batch, n1_log,
      n2_log, tc_log);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv_cols(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, u64 n_inv, u64 n_inv_con, u64 f_tmp, u64 f_con_lo,
                    int f_con_hi, int batch, int n1_log, int n2_log, int tc_log,
                    void* stream) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tc_log, n2_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int count = 1 << (n1_log + tc_log);
  const size_t smem = sizeof(T) * count;
  cudaError_t err = prepare(inv_cols_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  FinalConsts<T> fc;
  fc.n_inv = (T)n_inv;
  fc.n_inv_con = (T)n_inv_con;
  fc.tmp = (T)f_tmp;
  fc.con_lo = (T)f_con_lo;
  fc.con_hi = f_con_hi;
  inv_cols_kernel<T><<<(unsigned)blocks, tile_threads(count), smem,
                       (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q, fc, batch, n1_log,
      n2_log, tc_log);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_rows(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tr_log,
                    int strict, int out_transposed, void* stream) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tr_log, n1_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int count = 1 << (n2_log + tr_log);
  const size_t smem = sizeof(T) * ((size_t)row_pitch(n2_log, tr_log, sizeof(T)) << tr_log);
  cudaError_t err = prepare(fwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_rows_kernel<T><<<(unsigned)blocks, tile_threads(count), smem,
                       (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q, batch, n1_log,
      n2_log, tr_log, strict, out_transposed);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv_rows(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tr_log,
                    int in_transposed, void* stream) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tr_log, n1_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int count = 1 << (n2_log + tr_log);
  const size_t smem = sizeof(T) * ((size_t)row_pitch(n2_log, tr_log, sizeof(T)) << tr_log);
  cudaError_t err = prepare(inv_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  inv_rows_kernel<T><<<(unsigned)blocks, tile_threads(count), smem,
                       (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q, batch, n1_log,
      n2_log, tr_log, in_transposed);
  return (int)cudaGetLastError();
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu).  Every launcher enqueues one launch on
// `stream` over `batch` polynomials of N = 2^(n1_log + n2_log) in the layouts
// above, with tiles of 2^tc_log columns or 2^tr_log rows, and returns the
// cudaError_t of the launch; a nonzero value means the kernel never ran.
extern "C" {

#define NTT_TWOPASS_ENTRIES(W, T)                                                  \
  int ntt_fwd_cols_u##W(const void* in, void* out, const void* w,                \
                        const void* w_con, unsigned long long q, int batch,      \
                        int n1_log, int n2_log, int tc_log, void* stream) {      \
    return ntt::launch_fwd_cols<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tc_log, stream);                              \
  }                                                                              \
  int ntt_fwd_rows_u##W(const void* in, void* out, const void* w,                \
                        const void* w_con, unsigned long long q, int batch,      \
                        int n1_log, int n2_log, int tr_log, int strict,          \
                        int out_transposed, void* stream) {                      \
    return ntt::launch_fwd_rows<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tr_log, strict, out_transposed, stream);      \
  }                                                                              \
  int ntt_inv_rows_u##W(const void* in, void* out, const void* w,                \
                        const void* w_con, unsigned long long q, int batch,      \
                        int n1_log, int n2_log, int tr_log, int in_transposed,   \
                        void* stream) {                                          \
    return ntt::launch_inv_rows<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tr_log, in_transposed, stream);               \
  }                                                                              \
  int ntt_inv_cols_u##W(const void* in, void* out, const void* w,                \
                        const void* w_con, unsigned long long q,                 \
                        unsigned long long n_inv, unsigned long long n_inv_con,  \
                        unsigned long long f_tmp, unsigned long long f_con_lo,   \
                        int f_con_hi, int batch, int n1_log, int n2_log,         \
                        int tc_log, void* stream) {                              \
    return ntt::launch_inv_cols<T>(in, out, w, w_con, q, n_inv, n_inv_con,       \
                                   f_tmp, f_con_lo, f_con_hi, batch, n1_log,     \
                                   n2_log, tc_log, stream);                      \
  }

NTT_TWOPASS_ENTRIES(32, ntt::u32)
NTT_TWOPASS_ENTRIES(64, ntt::u64)

#undef NTT_TWOPASS_ENTRIES

}  // extern "C"
