// K11: (mat @ x) mod q on the int8 tensor cores, strict, q < 2^28 -- the two
// matrix passes of the 'mxu' variant.
//
// Replaces ntt_tpu/kernels/mxu.py:107-152 (_horner_mod_q and _matmul_mod_q,
// int8-limb matmuls on the TPU's MXU with the recombination on its VPU; XLA,
// not Pallas) and the twiddle / scale product between the passes (:170,
// :252), which is fused into the first pass here.  One launch computes one
// contract on int32 words below 2^28 (bits 28-31 are dropped, as in JAX):
//
//   left:  out[b, j, i] = sum_k mat[j, k] * x[b, k, i]   x (batch, K, F)
//   right: out[r, j]    = sum_k x[r, k] * mat[j, k]      x (rows, K)
//
// mat is K x K, given as its four 7-bit limbs (4, K, K) int8.  Each word of x
// is split into its four 7-bit limbs as it is staged into shared memory.  The
// 16 limb products run on mma.sync.m16n8k32 s8 x s8 -> s32 and accumulate
// into the 7 diagonal sums D_d = sum_{s + t = d} mat_s @ x_t.  Bound on a
// diagonal: at most 4 products of limbs 0..127 over K terms, 4 * 127^2 * K
// <= 2^28 for K <= 4096 (m24), so int32 holds it exactly; limbs 0..127 fit
// signed int8.  The epilogue recombines sum_d D_d 2^(7d) mod q as JAX does,
// by a Shoup-Horner chain by 2^7 mod q (acc < 2q + 2^28 < 2^32) and a Barrett
// reduction to [0, q); where the call passes an (N1, N2) table (s, s_con)
// with its word-32 Shoup constants, it then takes the strict product by the
// table's entry (left: s[j, i]; right: s[r mod N1, j]).  Every output is the
// exact residue, so any exact recombination gives the same bits.
//
// What bounds it on an H100: at m14 batch 1024 one pass moves 134 MB (40.1
// us at 3.35 TB/s) and does 32 K int8 operations a word (68.7 G, 34.7 us at
// the data sheet's 1,979 dense int8 TOPS); from m16 (K = 256) the int8
// operations bound it.  Design, simple first: one 64 x 32 output tile a block of four
// warps (2 x 2, a 32 x 16 warp tile of 2 x 2 mma tiles, 7 diagonals x 4
// tiles x 4 = 112 accumulator registers a thread), the contraction in steps
// of 64 staged through shared memory with plain loads, each limb plane a row
// of 64 + 16 bytes so that the fragment loads hit 32 distinct banks.  The
// A operand (left: mat; right: x) is row-major in shared memory and the B
// operand is stored n-major (k contiguous), the column-major B that
// m16n8k32.row.col takes; in `left` B is x[b], which is staged transposed
// (ldmatrix.trans does not take 8-bit elements).  A contraction shorter than
// one mma step (K < 32: up to m9 in `left`, m8 in `right`; m1 has N1 = 1) is
// zero-padded, and the ragged output edge is masked.  The grid is
// one-dimensional, the tile of the short output axis varying fastest, so
// that the blocks that share the long axis's operand run together and read
// it from L2.
// wgmma, TMA and a ring of stages are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt {

constexpr int kLimbs = 4, kDiags = 2 * kLimbs - 1, kLimbBits = 7;
constexpr int kMmaThreads = 128;
constexpr int kBM = 64, kBN = 32, kBK = 64;
constexpr int kPitch = kBK + 16;  // bytes a staged row of one limb plane

struct LimbShape {
  long long rows;   // M: output rows (left: K; right: rows of x)
  long long cols;   // N: output columns (left: batch * F; right: K)
  int k;            // the contraction's depth K
  int f_log;        // left: log2 F; right: log2 N1 (the scale's row period)
  int col_tiles;    // tiles along N
  int row_tiles;    // tiles along M
  u32 q, c128, c128_con, mu;
};

__device__ __forceinline__ u32 limb_pack(u32 w0, u32 w1, u32 w2, u32 w3, int s) {
  const int sh = kLimbBits * s;
  return ((w0 >> sh) & 127u) | (((w1 >> sh) & 127u) << 8) | (((w2 >> sh) & 127u) << 16) |
         (((w3 >> sh) & 127u) << 24);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + R) x [k0, k0 + kBK) of the limb matrix (4, K, K)
// into plane[4][R][kPitch]; rows at or past `nrows` and columns past K are 0.
template <int R>
__device__ __forceinline__ void stage_matrix(int8_t* plane, const int8_t* __restrict__ mat,
                                             long long nrows, int k, long long row0, int k0) {
  const long long kk = (long long)k * k;
  if (k % 16 == 0) {
    constexpr int kChunks = kLimbs * R * (kBK / 16);  // 16 bytes each
    for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
      const int s = c / (R * (kBK / 16)), rem = c % (R * (kBK / 16));
      const int r = rem / (kBK / 16), kc = (rem % (kBK / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < nrows && k0 + kc < k)
        v = __ldg(reinterpret_cast<const int4*>(mat + s * kk + (row0 + r) * k + k0 + kc));
      *reinterpret_cast<int4*>(plane + (s * R + r) * kPitch + kc) = v;
    }
  } else {  // K < 16: one byte at a time
    for (int e = threadIdx.x; e < kLimbs * R * kBK; e += kMmaThreads) {
      const int s = e / (R * kBK), rem = e % (R * kBK);
      const int r = rem / kBK, kc = rem % kBK;
      int8_t v = 0;
      if (row0 + r < nrows && k0 + kc < k) v = mat[s * kk + (row0 + r) * k + k0 + kc];
      plane[(s * R + r) * kPitch + kc] = v;
    }
  }
}

// right: A[r][k] = x[r * K + k], rows [row0, row0 + kBM), split into limbs.
__device__ __forceinline__ void stage_x_rows(int8_t* plane, const u32* __restrict__ x,
                                             const LimbShape& s, long long row0, int k0) {
  if (s.k % 4 == 0) {
    constexpr int kChunks = kBM * (kBK / 4);  // 4 words each
    for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
      const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < s.rows && k0 + kc < s.k)
        v = __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * s.k + k0 + kc));
#pragma unroll
      for (int l = 0; l < kLimbs; ++l)
        *reinterpret_cast<u32*>(plane + (l * kBM + r) * kPitch + kc) =
            limb_pack(v.x, v.y, v.z, v.w, l);
    }
  } else {  // K = 2
    for (int e = threadIdx.x; e < kBM * kBK; e += kMmaThreads) {
      const int r = e / kBK, kc = e % kBK;
      u32 w = 0;
      if (row0 + r < s.rows && k0 + kc < s.k) w = x[(row0 + r) * s.k + k0 + kc];
#pragma unroll
      for (int l = 0; l < kLimbs; ++l)
        plane[(l * kBM + r) * kPitch + kc] = (int8_t)((w >> (kLimbBits * l)) & 127u);
    }
  }
}

// left: B[k][n] = x[(n >> f_log) * K * F + k * F + (n & (F - 1))] for columns
// [col0, col0 + kBN), stored n-major (plane[l][n][k]), split into limbs.  A
// thread takes one column and four consecutive k, so a warp reads 32
// neighbouring columns of one k.
__device__ __forceinline__ void stage_x_cols(int8_t* plane, const u32* __restrict__ x,
                                             const LimbShape& s, long long col0, int k0) {
  const int n = threadIdx.x % kBN;
  const long long col = col0 + n;
  const long long f = 1ll << s.f_log;
  const long long base = (col >> s.f_log) * s.k * f + (col & (f - 1));
  for (int kq = threadIdx.x / kBN; kq < kBK / 4; kq += kMmaThreads / kBN) {
    u32 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + 4 * kq + j;
      w[j] = (col < s.cols && kk < s.k) ? __ldg(x + base + kk * f) : 0u;
    }
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      *reinterpret_cast<u32*>(plane + (l * kBN + n) * kPitch + 4 * kq) =
          limb_pack(w[0], w[1], w[2], w[3], l);
  }
}

template <bool kLeft, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
limb_matmul_kernel(const int8_t* __restrict__ mat, const u32* __restrict__ x,
                   u32* __restrict__ out, const u32* __restrict__ s_tab,
                   const u32* __restrict__ s_con, LimbShape s) {
  __shared__ __align__(16) int8_t a_s[kLimbs * kBM * kPitch];
  __shared__ __align__(16) int8_t b_s[kLimbs * kBN * kPitch];

  // the short axis's tile varies fastest: left, the K rows; right, the K columns
  long long row_tile, col_tile;
  if (kLeft) {
    row_tile = blockIdx.x % s.row_tiles;
    col_tile = blockIdx.x / s.row_tiles;
  } else {
    col_tile = blockIdx.x % s.col_tiles;
    row_tile = blockIdx.x / s.col_tiles;
  }
  const long long row0 = row_tile * kBM, col0 = col_tile * kBN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;

  int acc[kDiags][2][2][4];
#pragma unroll
  for (int d = 0; d < kDiags; ++d)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0;

  for (int k0 = 0; k0 < s.k; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are read
    if (kLeft) {
      stage_matrix<kBM>(a_s, mat, s.rows, s.k, row0, k0);
      stage_x_cols(b_s, x, s, col0, k0);
    } else {
      stage_x_rows(a_s, x, s, row0, k0);
      stage_matrix<kBN>(b_s, mat, s.cols, s.k, col0, k0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      if (k0 + ks >= s.k) break;  // the rest of the step is zero padding
      u32 b[kLimbs][2][2];
#pragma unroll
      for (int t = 0; t < kLimbs; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int8_t* p = b_s + (t * kBN + wn + 8 * j + g) * kPitch + ks + 4 * tq;
          b[t][j][0] = *reinterpret_cast<const u32*>(p);
          b[t][j][1] = *reinterpret_cast<const u32*>(p + 16);
        }
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) {
        u32 a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* p = a_s + (l * kBM + wm + 16 * i + g) * kPitch + ks + 4 * tq;
          a[i][0] = *reinterpret_cast<const u32*>(p);
          a[i][1] = *reinterpret_cast<const u32*>(p + 8 * kPitch);
          a[i][2] = *reinterpret_cast<const u32*>(p + 16);
          a[i][3] = *reinterpret_cast<const u32*>(p + 8 * kPitch + 16);
        }
#pragma unroll
        for (int t = 0; t < kLimbs; ++t)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_s8(acc[l + t][i][j], a[i], b[t][j]);
      }
    }
  }

  // epilogue: c[e] of an mma tile sits at row g (+8 for e >= 2), column
  // 2 tq + (e & 1); each thread writes two neighbouring columns at once
  const long long f_mask = (1ll << s.f_log) - 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + wm + 16 * i + g + 8 * h;
        const long long c = col0 + wn + 8 * j + 2 * tq;
        if (r >= s.rows || c >= s.cols) continue;  // cols is even: c + 1 is in too
        u32 v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u32 t = (u32)acc[kDiags - 1][i][j][2 * h + e];
#pragma unroll
          for (int d = kDiags - 2; d >= 0; --d)
            t = shoup_mul_q2<u32>(s.c128, s.c128_con, t, s.q) + (u32)acc[d][i][j][2 * h + e];
          t -= mulhi(s.mu, t) * s.q;  // Barrett: [0, 3q)
          v[e] = reduce_4q_to_q<u32>(t, s.q);
        }
        long long o, si;
        if (kLeft) {  // column c = b * F + i0: out[b, r, i0], s[r, i0]
          o = (c >> s.f_log) * s.k * (f_mask + 1) + r * (f_mask + 1) + (c & f_mask);
          si = r * (f_mask + 1) + (c & f_mask);
        } else {  // out[r, c], s[r mod N1, c]
          o = r * s.k + c;
          si = (r & f_mask) * s.k + c;
        }
        if (kScaled) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = reduce_2q_to_q<u32>(
                shoup_mul_q2<u32>(__ldg(s_tab + si + e), __ldg(s_con + si + e), v[e], s.q), s.q);
        }
        *reinterpret_cast<uint2*>(out + o) = make_uint2(v[0], v[1]);
      }
}

template <bool kLeft, bool kScaled>
int launch_limb_matmul(const void* mat, const void* x, void* out, const void* s_tab,
                       const void* s_con, unsigned long long q, long long batch, int k_log,
                       int f_log, void* stream) {
  if (q < 3 || q >= (1ull << (kLimbs * kLimbBits)) || batch < 1 || k_log < 0 || k_log > 12 ||
      f_log < 0 || f_log > 30)
    return (int)cudaErrorInvalidValue;
  LimbShape s;
  s.k = 1 << k_log;
  s.f_log = f_log;
  if (kLeft) {  // x (batch, K, F): rows K, columns batch * F
    s.rows = s.k;
    s.cols = batch << f_log;
  } else {  // x (batch, K): rows batch, columns K; the scale's rows repeat every 2^f_log
    s.rows = batch;
    s.cols = s.k;
  }
  if (s.cols % 2 != 0) return (int)cudaErrorInvalidValue;  // the pair stores
  const long long row_tiles = (s.rows + kBM - 1) / kBM, col_tiles = (s.cols + kBN - 1) / kBN;
  const long long blocks = row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.row_tiles = (int)row_tiles;
  s.col_tiles = (int)col_tiles;
  s.q = (u32)q;
  s.c128 = (u32)((1ull << kLimbBits) % q);
  s.c128_con = (u32)(((u64)s.c128 << 32) / q);
  s.mu = (u32)((1ull << 32) / q);
  limb_matmul_kernel<kLeft, kScaled><<<(unsigned)blocks, kMmaThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)mat, (const u32*)x, (u32*)out, (const u32*)s_tab, (const u32*)s_con, s);
  return (int)cudaGetLastError();
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu).  mat: (4, K, K) int8 limbs, K =
// 2^k_log <= 4096; x and out uint32 words; q < 2^28.  left: x (batch, K, F),
// F = 2^f_log, the table (K, F); right: x (batch, K) (batch = rows), the
// table (2^f_log, K) applied to row r at r mod 2^f_log.  The _scaled entry
// points take the table and its word-32 Shoup constants; the others ignore
// s_tab and s_con.
extern "C" {

#define NTT_LIMB_MATMUL(name, left, scaled)                                                 \
  int name(const void* mat, const void* x, void* out, const void* s_tab, const void* s_con, \
           unsigned long long q, long long batch, int k_log, int f_log, void* stream) {     \
    return ntt::launch_limb_matmul<left, scaled>(mat, x, out, s_tab, s_con, q, batch, k_log,  \
                                                 f_log, stream);                            \
  }

NTT_LIMB_MATMUL(ntt_limb_matmul_left, true, false)
NTT_LIMB_MATMUL(ntt_limb_matmul_left_scaled, true, true)
NTT_LIMB_MATMUL(ntt_limb_matmul_right, false, false)
NTT_LIMB_MATMUL(ntt_limb_matmul_right_scaled, false, true)

#undef NTT_LIMB_MATMUL

}  // extern "C"
