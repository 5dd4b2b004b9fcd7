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
// Design: one block per tile, the tile held in dynamic shared memory.
//   * Column passes: a tile is N1 rows x TC consecutive columns.  Each row
//     segment of TC words is one coalesced read, so TC is at least one 32-byte
//     sector's worth of words (4 at word 64, 8 at word 32), and grows while
//     the tile stays small (kernels/twopass.py picks every tile).
//   * Row passes: a tile is TR consecutive rows of N2.  Rows are contiguous in
//     the (N1, N2) layout; in the (N2, N1) layout the TR rows of one column
//     are TR consecutive words, so a tile that reads or writes that layout
//     holds at least a sector's worth of rows, and the tile's row pitch is
//     padded so that the transposed accesses of a warp fall in distinct
//     shared-memory banks.
//   * Blocks are numbered batch-fastest, so the blocks running together on
//     the card work on the same rows of different polynomials and share the
//     row twiddles in L2.
// Each is built with both reduction policies of modarith.cuh (ShoupRed,
// SolinasRed; see ntt_fused.cu), 32 instantiations each.
// All four run the register rounds of rounds.cuh on their tile (K4 / K5
// forward, K6 / K7 inverse, as K1 / K2 run them on a whole polynomial): each
// thread holds 2^K words of one column or row and runs K stages on them with
// no barrier, reading each twiddle pair once a round, and the block exchanges
// the tile through padded shared memory only between rounds (one barrier a
// round, where the first design had one a stage).  A warp's lanes walk the
// TC columns of a group (K4, K7: each register's load or store moves whole
// row segments of TC words) or the consecutive groups of a row (K5, K6).  The
// first round loads from device memory straight into registers: K4 / K5 at
// stride N / R, K7 at T = 1, K6 at T = 1 with 16-byte loads of the R
// consecutive words of a row (from the (N2, N1) layout K6 first stages the
// tile into the exchange buffer, TR consecutive words a column).  The last
// round stores from registers (K4; K6 at stride N2 / R, consecutive words
// across a warp; K7 after the fused final stage, strict), except K5's, which
// goes through the exchange buffer for the strict reduce and the layout of
// its output.  Row r's twiddle base N1 + r keeps every index the flat
// transform's.
// Element offsets into device memory are size_t: batch x N passes 2^31.
#include <climits>

#include <cuda_runtime.h>

#include "modarith.cuh"
#include "rounds.cuh"

namespace ntt {

constexpr int kTileThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a Hopper block can use

// K4-K7's bound on registers at each width: room for kMinBlocks blocks of
// kTileThreads threads on an SM.
template <typename T>
struct TwoPass;
template <>
struct TwoPass<u32> {
  static constexpr int kMinBlocks = 2;
};
template <>
struct TwoPass<u64> {
  static constexpr int kMinBlocks = 1;
};

// ---------------------------------------------------------------------------
// column passes: tile (N1, TC) at columns [c0, c0 + TC) of one polynomial
// ---------------------------------------------------------------------------

// K4 / K7's map: the TC = 2^vlog columns of an (N1, TC) column tile.  Word x of
// column v is row x; in the exchange buffer column v is a padded polynomial
// at v * pitch.  The lanes of a warp walk the TC columns of a group fastest,
// so each load or store of a register moves whole row segments of TC words.
template <typename T>
struct ColRounds {
  static constexpr bool vec = false;  // a column's words are N2 apart
  int logn, vlog, n2_log, pitch;
  __device__ __forceinline__ void lane(int j, int, int& v, int& g) const {
    v = j & ((1 << vlog) - 1);
    g = j >> vlog;
  }
  __device__ __forceinline__ size_t dev(int v, int x) const {
    return ((size_t)x << n2_log) + v;
  }
  __device__ __forceinline__ int sm(int v, int x) const { return v * pitch + padded<T>(x); }
  __device__ __forceinline__ int base(int) const { return 1; }
};

// K4: the column stages of one (N1, TC) tile in rounds of K, loaded from
// device memory into the first round's registers and stored from the last
// round's (row segments of TC words, whole sectors), lazy (< 4q).
template <typename T, int K, class Red>
__global__ void __launch_bounds__(kTileThreads, TwoPass<T>::kMinBlocks)
fwd_cols_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                const T* __restrict__ w_con, T q, int batch, int n1_log, int n2_log,
                int tc_log, int pitch, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t tile = ((size_t)(blockIdx.x % batch) << (n1_log + n2_log)) +
                      ((size_t)(blockIdx.x / batch) << tc_log);
  const ColRounds<T> tl{n1_log, tc_log, n2_log, pitch};
  tile_forward<T, K>(tl, in + tile, out + tile, sm, w, w_con, q, red);
}

// K7: the inverse column stages of one (N1, TC) tile in rounds of K, from
// the last down to the fused final stage (n^-1 folded in), loaded from device
// memory into the first round's registers and stored, strict and in the
// standard order, from the last round's (row segments of TC words).
template <typename T, int K, class Red>
__global__ void __launch_bounds__(kTileThreads, TwoPass<T>::kMinBlocks)
inv_cols_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                const T* __restrict__ w_con, T q, FinalConsts<T> fc, int batch, int n1_log,
                int n2_log, int tc_log, int pitch, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t tile = ((size_t)(blockIdx.x % batch) << (n1_log + n2_log)) +
                      ((size_t)(blockIdx.x / batch) << tc_log);
  const ColRounds<T> tl{n1_log, tc_log, n2_log, pitch};
  tile_inverse<T, K>(tl, in + tile, out + tile, sm, w, w_con, q, red, fc, true);
}

// ---------------------------------------------------------------------------
// row passes: tile of TR rows [r0, r0 + TR) of one polynomial, row pitch P
// ---------------------------------------------------------------------------

// K5 / K6's map: the TR = 2^vlog rows r0 .. r0 + TR - 1 of a row tile.  Word
// x of row v is column x, the rows contiguous in device memory; in the
// exchange buffer row v is a padded polynomial at v * pitch.  The lanes of a
// warp walk the groups of a row fastest; row v's twiddle base is N1 + r0 + v.
// vec: the tile's input and output are 16-byte aligned (K6 sets it).
template <typename T>
struct RowRounds {
  int logn, vlog, base0, pitch;
  bool vec = false;
  __device__ __forceinline__ void lane(int j, int glog, int& v, int& g) const {
    v = j >> glog;
    g = j & ((1 << glog) - 1);
  }
  __device__ __forceinline__ size_t dev(int v, int x) const {
    return ((size_t)v << logn) + x;
  }
  __device__ __forceinline__ int sm(int v, int x) const { return v * pitch + padded<T>(x); }
  __device__ __forceinline__ int base(int v) const { return base0 + v; }
};

// K5: the row stages of TR rows in rounds of K, loaded from device memory
// into the first round's registers; the last round writes the exchange
// buffer, from which the tile leaves in coalesced pieces, with the strict
// 4q -> q reduce on the way: 16-byte stores of each row in the (N1, N2)
// layout, or in the (N2, N1) layout TR consecutive words a column.
template <typename T, int K, class Red>
__global__ void __launch_bounds__(kTileThreads, TwoPass<T>::kMinBlocks)
fwd_rows_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                const T* __restrict__ w_con, T q, int batch, int n1_log, int n2_log,
                int tr_log, int pitch, int strict, int out_transposed, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t poly = (size_t)(blockIdx.x % batch) << (n1_log + n2_log);
  const int r0 = (int)(blockIdx.x / batch) << tr_log;
  const size_t tile = poly + ((size_t)r0 << n2_log);
  const RowRounds<T> tl{n2_log, tr_log, (1 << n1_log) + r0, pitch};
  const int count = 1 << (n2_log + tr_log);
  if (n2_log == 0) {  // rows of one word: no stages
    for (int i = threadIdx.x; i < count; i += blockDim.x) sm[tl.sm(i, 0)] = in[tile + i];
  } else {
    tile_forward<T, K>(tl, in + tile, nullptr, sm, w, w_con, q, red);
  }
  __syncthreads();
  typedef Vec16<T> V;
  if (out_transposed) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int k = i >> tr_log;
      const int rr = i & ((1 << tr_log) - 1);
      const T x = sm[tl.sm(rr, k)];
      out[poly + ((size_t)k << n1_log) + r0 + rr] = strict ? reduce_4q_to_q<T>(x, q) : x;
    }
  } else if ((1 << n2_log) >= V::n && (reinterpret_cast<size_t>(out) & 15) == 0) {
    typename V::type* g = reinterpret_cast<typename V::type*>(out + tile);
    for (int u = threadIdx.x; u < count / V::n; u += blockDim.x) {
      const int i = u * V::n;
      const int rr = i >> n2_log;
      const int k = i & ((1 << n2_log) - 1);
      T d[V::n];
#pragma unroll
      for (int c = 0; c < V::n; ++c) {
        const T x = sm[tl.sm(rr, k + c)];
        d[c] = strict ? reduce_4q_to_q<T>(x, q) : x;
      }
      g[u] = V::make(d);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const T x = sm[tl.sm(i >> n2_log, i & ((1 << n2_log) - 1))];
      out[tile + i] = strict ? reduce_4q_to_q<T>(x, q) : x;
    }
  }
}

// K6: the inverse row stages of TR rows in rounds of K, from the last down.
// From the (N1, N2) layout the first round loads each group's R consecutive
// words from device memory into registers; from the (N2, N1) layout the tile
// is first staged into the exchange buffer, TR consecutive words a column,
// and the first round reads it there.  The last round stores from registers
// into the (N1, N2) layout, consecutive words across a warp.
template <typename T, int K, class Red>
__global__ void __launch_bounds__(kTileThreads, TwoPass<T>::kMinBlocks)
inv_rows_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ w,
                const T* __restrict__ w_con, T q, int batch, int n1_log, int n2_log,
                int tr_log, int pitch, int in_transposed, Red red) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t poly = (size_t)(blockIdx.x % batch) << (n1_log + n2_log);
  const int r0 = (int)(blockIdx.x / batch) << tr_log;
  const size_t tile = poly + ((size_t)r0 << n2_log);
  const int count = 1 << (n2_log + tr_log);
  if (n2_log == 0) {  // rows of one word: no stages, and the two layouts agree
    for (int i = threadIdx.x; i < count; i += blockDim.x) out[tile + i] = in[tile + i];
    return;
  }
  const bool aligned =
      ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
  const RowRounds<T> tl{n2_log, tr_log, (1 << n1_log) + r0, pitch, aligned};
  const T* gin = in + tile;
  if (in_transposed) {
    // R loads in flight a thread before its stores: count is a multiple of
    // R x blockDim.x (the launcher gives at most one thread a group)
    constexpr int R = 1 << K;
    const int mask = (1 << tr_log) - 1;
    for (int i0 = threadIdx.x; i0 < count; i0 += R * blockDim.x) {
      T x[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = i0 + u * blockDim.x;
        x[u] = __ldg(in + poly + ((size_t)(i >> tr_log) << n1_log) + r0 + (i & mask));
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = i0 + u * blockDim.x;
        sm[tl.sm(i & mask, i >> tr_log)] = x[u];
      }
    }
    __syncthreads();
    gin = nullptr;
  }
  tile_inverse<T, K>(tl, gin, out + tile, sm, w, w_con, q, red, FinalConsts<T>(), false);
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

// K4-K7's rounds on a tile of 2^vlog transforms of 2^logn words: K stages
// a round, 2^K words a group (K = 4, fewer on a shorter transform; logn = 0
// takes K = 1 and runs no round), two groups a thread (at least a warp, at
// most kTileThreads), and an exchange buffer of `pitch` words a transform: a
// transform padded by one word a bank row (rounds.cuh's padded), rounded up
// to whole bank rows, plus row / 2^vlog words, which puts the transforms'
// words of one access in distinct banks.  kernels/twopass.py's
// round_tile_log picks vlog with the same pitch.
constexpr int kRoundLog = 4;

inline int round_log(int logn) {
  return logn < kRoundLog ? (logn > 0 ? logn : 1) : kRoundLog;
}

inline int round_threads(int logn, int vlog) {
  const int excess = logn - round_log(logn);
  const int groups = 1 << ((excess > 0 ? excess : 0) + vlog);
  const int warp = groups < 32 ? groups : 32;
  const int threads = (groups >> 1) > warp ? groups >> 1 : warp;
  return threads < kTileThreads ? threads : kTileThreads;
}

template <typename T>
size_t round_smem(int logn, int vlog, int& pitch) {
  const int row = 1 << kRowLog<T>;
  const long long n = 1LL << logn;
  const long long padded = n + ((n - 1) >> kRowLog<T>);
  const int pad = row >> vlog;
  pitch = (int)((padded + row - 1) / row * row) + (pad > 1 ? pad : 1);
  return sizeof(T) * ((size_t)pitch << vlog);
}

#define NTT_BY_LOG_R(KERNEL, T, LOG_R)                                                \
  ((LOG_R) == 1 ? KERNEL<T, 1, Red> : (LOG_R) == 2 ? KERNEL<T, 2, Red>              \
                                    : (LOG_R) == 3 ? KERNEL<T, 3, Red> : KERNEL<T, 4, Red>)

template <typename T, class Red = ShoupRed>
int launch_fwd_cols(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tc_log, void* stream,
                    Red red = Red()) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tc_log, n2_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  int pitch;
  const size_t smem = round_smem<T>(n1_log, tc_log, pitch);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_blocks(NTT_BY_LOG_R(fwd_cols_kernel, T, round_log(n1_log)), (int)blocks,
                       round_threads(n1_log, tc_log), smem,
                       stream, (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q,
                       batch, n1_log, n2_log, tc_log, pitch, red);
}

template <typename T, class Red = ShoupRed>
int launch_inv_cols(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, u64 n_inv, u64 n_inv_con, u64 f_tmp, u64 f_con_lo,
                    int f_con_hi, int batch, int n1_log, int n2_log, int tc_log,
                    void* stream, Red red = Red()) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tc_log, n2_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  int pitch;
  const size_t smem = round_smem<T>(n1_log, tc_log, pitch);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const FinalConsts<T> fc{(T)n_inv, (T)n_inv_con, (T)f_tmp, (T)f_con_lo, f_con_hi};
  return launch_blocks(NTT_BY_LOG_R(inv_cols_kernel, T, round_log(n1_log)), (int)blocks,
                       round_threads(n1_log, tc_log), smem,
                       stream, (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q, fc,
                       batch, n1_log, n2_log, tc_log, pitch, red);
}

template <typename T, class Red = ShoupRed>
int launch_fwd_rows(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tr_log, int strict,
                    int out_transposed, void* stream, Red red = Red()) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tr_log, n1_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  int pitch;
  const size_t smem = round_smem<T>(n2_log, tr_log, pitch);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_blocks(NTT_BY_LOG_R(fwd_rows_kernel, T, round_log(n2_log)), (int)blocks,
                       round_threads(n2_log, tr_log), smem,
                       stream, (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q,
                       batch, n1_log, n2_log, tr_log, pitch, strict, out_transposed, red);
}

template <typename T, class Red = ShoupRed>
int launch_inv_rows(const void* in, void* out, const void* w, const void* w_con,
                    u64 q, int batch, int n1_log, int n2_log, int tr_log,
                    int in_transposed, void* stream, Red red = Red()) {
  const long long blocks = pass_blocks(batch, n1_log, n2_log, tr_log, n1_log);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  int pitch;
  const size_t smem = round_smem<T>(n2_log, tr_log, pitch);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_blocks(NTT_BY_LOG_R(inv_rows_kernel, T, round_log(n2_log)), (int)blocks,
                       round_threads(n2_log, tr_log), smem,
                       stream, (const T*)in, (T*)out, (const T*)w, (const T*)w_con, (T)q,
                       batch, n1_log, n2_log, tr_log, pitch, in_transposed, red);
}

#undef NTT_BY_LOG_R

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

// The SolinasRed instantiations (see ntt_fused.cu): the same arguments with
// (e, k) before the stream; w_con is not read.
#define NTT_TWOPASS_SOLINAS(W, T)                                                  \
  int ntt_fwd_cols_solinas_u##W(const void* in, void* out, const void* w,        \
                                const void* w_con, unsigned long long q,         \
                                int batch, int n1_log, int n2_log, int tc_log,   \
                                int e, int k, void* stream) {                    \
    return ntt::launch_fwd_cols<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tc_log, stream, ntt::SolinasRed{e, k});       \
  }                                                                              \
  int ntt_fwd_rows_solinas_u##W(const void* in, void* out, const void* w,        \
                                const void* w_con, unsigned long long q,         \
                                int batch, int n1_log, int n2_log, int tr_log,   \
                                int strict, int out_transposed, int e, int k,    \
                                void* stream) {                                  \
    return ntt::launch_fwd_rows<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tr_log, strict, out_transposed, stream,       \
                                   ntt::SolinasRed{e, k});                       \
  }                                                                              \
  int ntt_inv_rows_solinas_u##W(const void* in, void* out, const void* w,        \
                                const void* w_con, unsigned long long q,         \
                                int batch, int n1_log, int n2_log, int tr_log,   \
                                int in_transposed, int e, int k, void* stream) { \
    return ntt::launch_inv_rows<T>(in, out, w, w_con, q, batch, n1_log, n2_log,  \
                                   tr_log, in_transposed, stream,                \
                                   ntt::SolinasRed{e, k});                       \
  }                                                                              \
  int ntt_inv_cols_solinas_u##W(const void* in, void* out, const void* w,        \
                                const void* w_con, unsigned long long q,         \
                                unsigned long long n_inv,                        \
                                unsigned long long n_inv_con,                    \
                                unsigned long long f_tmp,                        \
                                unsigned long long f_con_lo, int f_con_hi,       \
                                int batch, int n1_log, int n2_log, int tc_log,   \
                                int e, int k, void* stream) {                    \
    return ntt::launch_inv_cols<T>(in, out, w, w_con, q, n_inv, n_inv_con,       \
                                   f_tmp, f_con_lo, f_con_hi, batch, n1_log,     \
                                   n2_log, tc_log, stream, ntt::SolinasRed{e, k}); \
  }

NTT_TWOPASS_SOLINAS(32, ntt::u32)
NTT_TWOPASS_SOLINAS(64, ntt::u64)

#undef NTT_TWOPASS_SOLINAS

}  // extern "C"
