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
// mat is K x K, given as its four 7-bit limbs (4, K, K) int8, k contiguous.
// Each word of x is split into its four 7-bit limbs (0..127, which fit
// signed int8) in the kernel.  The 16 limb products mat_s @ x_t add into
// the 7 diagonals D_d = sum_{s + t = d} mat_s @ x_t, and the output is
// sum_d D_d 2^(7d) mod q; where the call passes an (N1, N2) table (s,
// s_con) with its word-32 Shoup constants, the strict product by the
// table's entry follows (left: s[j, i]; right: s[r mod N1, j]).  Every
// output is the exact residue, so any exact order of the sums gives the
// same bits.
//
// What bounds it on an H100: at m14 batch 1024 one pass moves 134 MB (40.1
// us at 3.35 TB/s) and does 32 K int8 operations a word (68.7 G, 34.7 us at
// the data sheet's 1,979 dense int8 TOPS), and its epilogue about 15-27
// 32-bit multiplies a word, near the memory floor too; from m16 (K = 256)
// the int8 operations bound it.  The mma.sync body below, alone, reached
// 8-14 % of that bound at K >= 128: 112 accumulators a thread (two blocks
// an SM), one shared-memory stage filled between barriers, and every x
// word split again for each 32-column output tile.
//
// Two bodies, picked by K alone (launch_limb_matmul; kernels/mxu.py body()):
//
// wgmma, K >= 128 (left from m14, right from m13).  Both contracts run as
// one product C[n, j] = sum_k X[n, k] mat[j, k]: right with X = x, left
// with the roles swapped (C = out^T, X[b * F + i, k] = x[b, k, i]), so that
// both operands are k-major in shared memory, as 8-bit wgmma requires, and
// the matrix is the B operand in both.  A CTA holds two pairs of
// warpgroups; a pair takes 64 rows of X and the CTA's tile of 128 columns
// j, each warpgroup of the pair 64 of them (wgmma.m64n64k32.s32.s8.s8).
// The grid is persistent: a CTA keeps its column tile and walks row tiles
// of 128, the column tile varying fastest so that the CTAs that share an x
// slab run together and read it from L2.  The matrix limbs come in by TMA
// (a 3-D tensor map over (4, K, K), a box of 128 k x 128 j x 4 limbs,
// 64 KB, taken through cudaGetDriverEntryPoint) in the 128-byte swizzle
// that the wgmma descriptors name: for K <= 256 every chunk of 128 k stays
// resident for the CTA's life (loaded once), beyond that a ring of two
// stages on mbarriers, refilled by the warpgroup that releases a stage
// last.  A pair splits each x word of its 64 rows into its four limbs once
// a column tile (byte permutes), writing the swizzled k-major limb planes
// of its buffer, the next unit's rows prefetched into L2 meanwhile.  For
// each chunk of 128 k the seven diagonals go through one int32 tile: each
// upper diagonal of a pair (D1, D3, D5) is shifted by 7 and the lower one
// summed onto it by the products (E0 = R + D0 + 2^7 D1 onto the carry R,
// E2, E4), and E2, E4 and D6 are folded into the u32 residue t by three
// Shoup products by 2^14, 2^28 and 2^42 mod q: two register tiles a
// thread, not seven, and half the epilogue's multiplies.  The finished
// tile goes through the pair's buffer (free once its products have run),
// so that the scale is read and the output written 16 bytes a thread in
// whole rows.
//
// Exactness of the wgmma body, at every K from 128 to 4096:
//  - a diagonal of one chunk sums at most 4 products over 128 terms of
//    limbs 0..127: D_d <= 4 * 127^2 * 128 < 2^23;
//  - E0 = R + 2^7 D1 + D0 < 2^29 + 2^30 + 2^23 and E2, E4 < 2^30 + 2^23:
//    every partial sum is below 2^31, in the int32 tile (R < 2q, q < 2^28);
//  - t = E0 + three Shoup products, each < 2q: t < 2^29 + 2^30 + 2^23 + 6q
//    < 2^32 in u32;
//  - Barrett (mu = floor(2^32 / q)) takes any t < 2^32 to the next carry R
//    in [0, 2q);
//  - after the last chunk R is reduced to [0, q) and scaled.
// tests/test_torch_mxu_order.py runs this order in int64 at the worst case
// (every limb 127, the widest 28-bit q) at every K and checks each bound.
//
// mma.sync, K < 128 (the first body): one 64 x 32 output tile a block of four
// warps on mma.sync.m16n8k32 s8, the contraction in steps of 64 staged
// through one shared-memory stage with plain loads (each limb plane a row
// of 64 + 16 bytes, so that the fragment loads hit 32 banks; left's x[b]
// transposed as it is split), 7 diagonal accumulators a thread over the
// whole K; a contraction shorter than one mma step (K < 32) is zero-padded
// and the ragged output edge masked.  Its epilogue is JAX's: a
// Shoup-Horner chain by 2^7 mod q (D_d <= 4 * 127^2 * K < 2^28 for any
// K <= 4096; acc < 2q + 2^28 < 2^32) and a Barrett reduction to [0, q).
#include <cuda.h>  // CUtensorMap: types only, the encoder comes through the runtime
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "modarith.cuh"

namespace ntt {

constexpr int kLimbs = 4, kDiags = 2 * kLimbs - 1, kLimbBits = 7;

// Byte b of the result is limb s of word w_b.
__device__ __forceinline__ u32 limb_pack(u32 w0, u32 w1, u32 w2, u32 w3, int s) {
  const int sh = kLimbBits * s;
  return ((w0 >> sh) & 127u) | (((w1 >> sh) & 127u) << 8) | (((w2 >> sh) & 127u) << 16) |
         (((w3 >> sh) & 127u) << 24);
}

// ------------------------------------------------------------------ mma.sync body, K < 128
namespace mma_body {

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
int launch(const void* mat, const void* x, void* out, const void* s_tab, const void* s_con,
           unsigned long long q, long long batch, int k_log, int f_log, void* stream) {
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

}  // namespace mma_body

// ------------------------------------------------------------------ wgmma body, K >= 128
namespace wg {

constexpr int kMinKLog = 7;                          // K >= 128
constexpr int kRows = 64;                            // rows of X a pair of warpgroups: wgmma's M
constexpr int kPairs = 2;                            // pairs a CTA, on their own rows
constexpr int kGroups = 2 * kPairs;                  // consumer warpgroups a CTA
constexpr int kThreads = 128 * kGroups;
constexpr int kTileCols = 128;                       // columns j of a CTA's tile (a pair's)
constexpr int kCols = kTileCols / 2;                 // columns a warpgroup: wgmma's N
constexpr int kChunk = 128;                          // k a chunk: a 128-byte swizzle row
constexpr int kStages = 2;
constexpr int kMatStage = kLimbs * kTileCols * kChunk;  // 64 KB, (limb, j, k)
constexpr int kXPlane = kRows * kChunk;              // 8 KB a limb
constexpr int kXBuf = kLimbs * kXPlane;              // 32 KB a pair
constexpr int kCellsPerWarp = (kRows / 8) * (kChunk / 16) / 8;  // cells of 8 rows x 16 k
constexpr int kAcc = kCols / 2;                      // accumulator registers a thread: 32

struct Shape {
  long long rows;       // rows n of X (left: batch * F; right: batch)
  long long row_tiles;  // of kPairs * kRows rows
  int k, f_log;         // K; left: log2 F, right: log2 N1 (the scale's row period)
  int col_tiles, chunks;  // K / kTileCols, K / kChunk
  u32 q, mu;
  u32 w[kDiags], w_con[kDiags];  // 2^(7d) mod q and its word-32 Shoup constant
};

__device__ __forceinline__ u32 smem_u32(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

// wgmma's shared-memory descriptor of a k-major operand in the 128-byte
// swizzle, 8-row groups 1024 bytes apart (SBO; the leading offset is
// unused), kOff bytes past the operand whose descriptor's low word is lo
// (lo_of).  Built in place by the asm, so that the compiler keeps one base
// register an operand and not every descriptor of a chunk.
__device__ __forceinline__ u32 lo_of(u32 addr) { return (addr >> 4) | (1u << 16); }

template <int kOff>
__device__ __forceinline__ uint64_t sw128_desc(u32 lo) {
  uint64_t d;
  asm volatile(
      "{\n"
      ".reg .u32 lo, hi;\n"
      "add.u32 lo, %1, %2;\n"
      "mov.u32 hi, %3;\n"
      "mov.b64 %0, {lo, hi};\n"
      "}\n"
      : "=l"(d)
      : "r"(lo), "n"(kOff >> 4), "n"((1024 >> 4) | (1 << 30)));
  return d;
}

__device__ __forceinline__ void mbar_init(u32 bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(u32 bar, u32 parity) {
  u32 done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity; a load that never lands faults
// (seconds of spinning) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(u32 bar, u32 parity) {
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins > (1ll << 30)) __trap();
}

__device__ __forceinline__ void tma_load_3d(u32 dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, u32 bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Named barriers: 1 + pair for the 256 threads of a pair, 1 + kPairs + group
// for one warpgroup (0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(pair + 1) : "memory");
}
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1 + kPairs) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void l2_prefetch(const void* p, u32 bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Pins the accumulator registers at this point of the program, so that the
// compiler reads them after wgmma_wait and writes them before wgmma_fence.
__device__ __forceinline__ void fence_regs(u32 (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32, descriptor a) @ B^T (64 x 32, descriptor b), int8 in,
// int32 sums; kAccumulate = 0 overwrites d.
template <int kAccumulate>
__device__ __forceinline__ void wgmma_s8(u32 (&d)[kAcc], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "n"(kAccumulate));
}

// Diagonal D of one chunk: sum over s + t = D of x_t @ mat_s^T, 4 k-steps
// a pair (S, KS: the pair's s and the k-step); the first product adds onto
// d_ only where kCarry says so.
template <int D, int kCarry, int S = (D < kLimbs ? 0 : D - kLimbs + 1), int KS = 0>
__device__ __forceinline__ void diagonal(u32 (&d_)[kAcc], u32 x_lo, u32 m_lo) {
  constexpr int kFirst = D < kLimbs ? 0 : D - kLimbs + 1;
  constexpr int kLast = D < kLimbs ? D : kLimbs - 1;
  wgmma_s8<(S == kFirst && KS == 0) ? kCarry : 1>(
      d_, sw128_desc<(D - S) * kXPlane + 32 * KS>(x_lo),
      sw128_desc<S * kTileCols * kChunk + 32 * KS>(m_lo));
  if constexpr (KS + 1 < kChunk / 32)
    diagonal<D, kCarry, S, KS + 1>(d_, x_lo, m_lo);
  else if constexpr (S < kLast)
    diagonal<D, kCarry, S + 1, 0>(d_, x_lo, m_lo);
}

// Limb l of four words, one a byte: three byte permutes and a mask.
__device__ __forceinline__ u32 limb_bytes(u32 w0, u32 w1, u32 w2, u32 w3, int l) {
  const int sh = kLimbBits * l;
  return __byte_perm(__byte_perm(w0 >> sh, w1 >> sh, 0x0040),
                     __byte_perm(w2 >> sh, w3 >> sh, 0x0040), 0x5410) &
         0x7f7f7f7fu;
}

// Stage one unit (a pair's 64 rows of X, one chunk of k) into the pair's
// buffer, each word split into its four limbs: plane l holds (64 rows,
// 128 k) int8, k-major, its 16-byte chunk c of row r at chunk c ^ (r % 8)
// (the 128-byte swizzle of the wgmma descriptor).  Warp w of the pair
// takes rows 8 w .. 8 w + 7: lane covers row 8 w + lane % 8 and k
// 16 i + 4 (lane / 8) + 0..3 of cell i, so that a warp's limb stores hit
// 32 banks.  Rows past the end are 0.
template <bool kLeft>
__device__ __forceinline__ void stage_x(uint8_t* xb, const u32* __restrict__ x,
                                        const Shape& s, long long row0, int k0, int warp,
                                        int lane) {
  const int r = 8 * warp + lane % 8;
  const long long row = row0 + r;
  u32 v[kCellsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
    const long long k = k0 + 16 * i + 4 * (lane / 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = 0u;
    if (row < s.rows) {
      if (kLeft) {  // X[b * F + i0, k] = x[b, k, i0]
        const long long f = 1ll << s.f_log;
        const u32* p = x + (row >> s.f_log) * s.k * f + k * f + (row & (f - 1));
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = __ldg(p + j * f);
      } else {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(x + row * s.k + k));
        v[i][0] = w.x;
        v[i][1] = w.y;
        v[i][2] = w.z;
        v[i][3] = w.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
    const int off = r * kChunk + ((i ^ (lane % 8)) << 4) + 4 * (lane / 8);
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      *reinterpret_cast<u32*>(xb + l * kXPlane + off) =
          limb_bytes(v[i][0], v[i][1], v[i][2], v[i][3], l);
  }
}

// Bring the x words of a later unit into L2 while this one's products run
// (one bulk prefetch a row of X, or a k of left's x where F >= 64 keeps the
// 64 rows in one polynomial).
template <bool kLeft>
__device__ __forceinline__ void prefetch_x(const u32* __restrict__ x, const Shape& s,
                                           long long row0, int k0, int tid) {
  if (row0 >= s.rows) return;
  if (kLeft) {
    if (s.f_log < 6 || tid >= kChunk) return;
    const long long f = 1ll << s.f_log;
    l2_prefetch(x + (row0 >> s.f_log) * s.k * f + (k0 + tid) * f + (row0 & (f - 1)), kRows * 4);
  } else if (tid < kRows && row0 + tid < s.rows) {
    l2_prefetch(x + (row0 + tid) * s.k + k0, kChunk * 4);
  }
}

// A finished tile: each warpgroup's residues R in [0, 2q) of the
// accumulator layout (register 4 i + 2 h + e of a thread is row
// 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e of its half),
// reduced to [0, q) and written to the pair's buffer (free once its
// products have run) as the output lays them out (right: [row][j], left:
// [j][row]; the 8-word blocks swizzled so that both passes hit 32 banks),
// then read back by the pair 16 bytes a thread, scaled and stored in whole
// rows: 512 bytes a warp (right) or 256 (left).
template <bool kLeft, bool kScaled>
__device__ __forceinline__ void store_tile(const u32 (&t)[kAcc], uint8_t* xb,
                                           u32* __restrict__ out, const u32* __restrict__ s_tab,
                                           const u32* __restrict__ s_con, const Shape& s,
                                           long long row0, int col0, int pair, int half,
                                           int warp, int lane, int tid) {
  u32* tile = reinterpret_cast<u32*>(xb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i) {
      const int c = half * kCols + 8 * i + 2 * (lane % 4);
      const u32 v0 = reduce_2q_to_q<u32>(t[4 * i + 2 * h], s.q);
      const u32 v1 = reduce_2q_to_q<u32>(t[4 * i + 2 * h + 1], s.q);
      if (kLeft) {
        const int sw = ((c >> 1) & 3) << 3;
        tile[c * kRows + (r ^ sw)] = v0;
        tile[(c + 1) * kRows + (r ^ sw)] = v1;
      } else {
        *reinterpret_cast<uint2*>(tile + r * kTileCols + (c ^ ((r & 7) << 3))) =
            make_uint2(v0, v1);
      }
    }
  }
  pair_sync(pair);
  const long long f = 1ll << s.f_log;
#pragma unroll 2
  for (int it = 0; it < kRows * kTileCols / 4 / 256; ++it) {
    const int idx = tid + 256 * it;
    if (kLeft) {  // tile row j: 64 rows n = b * F + i0 of out[b, col0 + j, :]
      const int j = idx / (kRows / 4), r = (idx % (kRows / 4)) * 4;
      const long long n = row0 + r, jj = col0 + j;
      if (n >= s.rows) continue;
      uint4 v = *reinterpret_cast<const uint4*>(tile + j * kRows + (r ^ (((j >> 1) & 3) << 3)));
      const long long i0 = n & (f - 1), o = (n >> s.f_log) * s.k * f + jj * f + i0;
      if (f >= 4) {  // four rows of one polynomial: 16 contiguous bytes
        if (kScaled) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(s_tab + jj * f + i0));
          const uint4 wc = __ldg(reinterpret_cast<const uint4*>(s_con + jj * f + i0));
          v.x = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.x, wc.x, v.x, s.q), s.q);
          v.y = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.y, wc.y, v.y, s.q), s.q);
          v.z = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.z, wc.z, v.z, s.q), s.q);
          v.w = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.w, wc.w, v.w, s.q), s.q);
        }
        *reinterpret_cast<uint4*>(out + o) = v;
      } else {  // F < 4: the four rows span polynomials
        const u32 vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long ne = n + e, ie = ne & (f - 1);
          u32 ve = vs[e];
          if (kScaled)
            ve = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(__ldg(s_tab + jj * f + ie),
                                                       __ldg(s_con + jj * f + ie), ve, s.q),
                                     s.q);
          out[(ne >> s.f_log) * s.k * f + jj * f + ie] = ve;
        }
      }
    } else {  // tile row r: out[row0 + r, col0 + c .. + 3], s[(row0 + r) mod N1, ...]
      const int r = idx / (kTileCols / 4), c = (idx % (kTileCols / 4)) * 4;
      const long long n = row0 + r;
      if (n >= s.rows) continue;
      uint4 v = *reinterpret_cast<const uint4*>(tile + r * kTileCols + (c ^ ((r & 7) << 3)));
      if (kScaled) {
        const long long si = (n & (f - 1)) * s.k + col0 + c;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(s_tab + si));
        const uint4 wc = __ldg(reinterpret_cast<const uint4*>(s_con + si));
        v.x = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.x, wc.x, v.x, s.q), s.q);
        v.y = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.y, wc.y, v.y, s.q), s.q);
        v.z = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.z, wc.z, v.z, s.q), s.q);
        v.w = reduce_2q_to_q<u32>(shoup_mul_q2<u32>(w.w, wc.w, v.w, s.q), s.q);
      }
      *reinterpret_cast<uint4*>(out + n * s.k + col0 + c) = v;
    }
  }
}

template <bool kLeft, bool kScaled>
__global__ void __launch_bounds__(kThreads, 1)
limb_matmul_wgmma(const __grid_constant__ CUtensorMap mat_map, const u32* __restrict__ x,
                  u32* __restrict__ out, const u32* __restrict__ s_tab,
                  const u32* __restrict__ s_con, const Shape s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const bool resident = s.chunks <= kStages;  // every chunk loaded once
  const int stages = resident ? s.chunks : kStages;
  uint8_t* mat_s = smem;
  const int group = threadIdx.x / 128, pair = group / 2, half = group % 2;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, tid = threadIdx.x % 256;
  uint8_t* xb = smem + stages * kMatStage + pair * kXBuf;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kMatStage + kPairs * kXBuf);
  int* released = reinterpret_cast<int*>(full + kStages);

  // this CTA's column tile, and its row tiles first, first + step, ...
  const int col_tile = blockIdx.x % s.col_tiles;
  const long long first = blockIdx.x / s.col_tiles, step = gridDim.x / s.col_tiles;
  const long long tiles = (s.row_tiles - first + step - 1) / step;
  const long long units = tiles * s.chunks;

  // unit u (row tile u / chunks, chunk u % chunks) into its stage
  auto load_mat = [&](long long u) {
    const int c = (int)(u % s.chunks);
    const int stage = resident ? c : (int)(u % kStages);
    const u32 bar = smem_u32(full + stage);
    mbar_expect_tx(bar, kMatStage);
    tma_load_3d(smem_u32(mat_s + stage * kMatStage), &mat_map, c * kChunk,
                col_tile * kTileCols, 0, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(full + i), 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long u = 0; u < units && u < stages; ++u) load_mat(u);
  }
  __syncthreads();

  const u32 x_lo = lo_of(smem_u32(xb));
  u32 t[kAcc], acc[kAcc];
  for (long long i = 0; i < tiles; ++i) {
    const long long row0 = (first + i * step) * (kPairs * kRows) + pair * kRows;
    for (int c = 0; c < s.chunks; ++c) {
      const long long u = i * s.chunks + c;
      pair_sync(pair);  // the last unit's products and tile have left the buffer
      stage_x<kLeft>(xb, x, s, row0, c * kChunk, tid / 32, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      pair_sync(pair);
      if (c + 1 < s.chunks)  // the next unit's x into L2
        prefetch_x<kLeft>(x, s, row0, (c + 1) * kChunk, tid);
      else if (i + 1 < tiles)
        prefetch_x<kLeft>(x, s, row0 + step * (kPairs * kRows), 0, tid);
      const int stage = resident ? c : (int)(u % kStages);
      mbar_wait(smem_u32(full + stage), resident ? 0u : (u32)((u / kStages) & 1));
      // this warpgroup's half of the matrix tile: rows half * 64 .. of each limb plane
      const u32 m_lo = lo_of(smem_u32(mat_s + stage * kMatStage) + half * kCols * kChunk);

      // The chunk's 7 diagonals as E0 = R + D0 + 2^7 D1 (R the carry, 0 in
      // chunk 0), E2 = D2 + 2^7 D3, E4 = D4 + 2^7 D5 and D6: each pair's
      // upper diagonal is shifted by 7 and the lower one summed onto it by
      // the products themselves; then t = E0 + (2^14 mod q) E2 + (2^28 mod
      // q) E4 + (2^42 mod q) D6, three Shoup products.  One accumulator tile
      // besides t: the four warpgroups of the CTA keep the tensor cores busy
      // while one of them shifts or folds.
#define NTT_K11_MMA(D, ACC, CARRY)   \
  fence_regs(ACC);                     \
  wgmma_fence();                       \
  diagonal<D, CARRY>(ACC, x_lo, m_lo); \
  wgmma_commit();
#define NTT_K11_FOLD(W) \
  _Pragma("unroll") for (int e = 0; e < kAcc; ++e) t[e] += shoup_mul_q2<u32>(s.w[W], s.w_con[W], acc[e], s.q);
      NTT_K11_MMA(1, acc, 0)
      wgmma_wait<0>();  // D1
      fence_regs(acc);
      {
        const u32 keep = c > 0 ? ~0u : 0u;  // the carry, or 0 in chunk 0
#pragma unroll
        for (int e = 0; e < kAcc; ++e) t[e] = (t[e] & keep) + (acc[e] << kLimbBits);
      }
      NTT_K11_MMA(0, t, 1)  // E0
      NTT_K11_MMA(3, acc, 0)
      wgmma_wait<0>();  // E0, D3
      fence_regs(t);
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] <<= kLimbBits;
      NTT_K11_MMA(2, acc, 1)  // E2
      wgmma_wait<0>();
      fence_regs(acc);
      NTT_K11_FOLD(2)
      NTT_K11_MMA(5, acc, 0)
      wgmma_wait<0>();  // D5
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] <<= kLimbBits;
      NTT_K11_MMA(4, acc, 1)  // E4
      wgmma_wait<0>();
      fence_regs(acc);
      NTT_K11_FOLD(4)
      NTT_K11_MMA(6, acc, 0)
      wgmma_wait<0>();  // D6
      fence_regs(acc);
      if (!resident) {  // the stage is read: the warpgroup that releases it last refills it
        group_sync(group);
        if (threadIdx.x % 128 == 0 &&
            atomicAdd(released + stage, 1) % kGroups == kGroups - 1 && u + kStages < units)
          load_mat(u + kStages);
      }
      NTT_K11_FOLD(6)
#undef NTT_K11_MMA
#undef NTT_K11_FOLD
#pragma unroll
      for (int e = 0; e < kAcc; ++e) t[e] -= mulhi(s.mu, t[e]) * s.q;  // Barrett: [0, 2q)
    }
    pair_sync(pair);  // both warpgroups' products have read the buffer
    store_tile<kLeft, kScaled>(t, xb, out, s_tab, s_con, s, row0, col_tile * kTileCols, pair,
                               half, warp, lane, tid);
  }
}

// cuTensorMapEncodeTiled through the runtime, so that no -lcuda is needed.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <bool kLeft, bool kScaled>
int launch(const void* mat, const void* x, void* out, const void* s_tab, const void* s_con,
           unsigned long long q, long long batch, int k_log, int f_log, void* stream) {
  Shape s;
  s.k = 1 << k_log;
  s.f_log = f_log;
  s.rows = kLeft ? batch << f_log : batch;
  s.row_tiles = (s.rows + kPairs * kRows - 1) / (kPairs * kRows);
  s.col_tiles = s.k / kTileCols;
  s.chunks = s.k / kChunk;
  s.q = (u32)q;
  s.mu = (u32)((1ull << 32) / q);
  for (int d = 0; d < kDiags; ++d) {
    s.w[d] = (u32)((1ull << (kLimbBits * d)) % q);
    s.w_con[d] = (u32)(((u64)s.w[d] << 32) / q);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // a CTA keeps one column tile: the grid is a multiple of the column tiles
  const long long per_col =
      std::max(1LL, std::min(s.row_tiles, (long long)(sms / s.col_tiles)));
  const long long grid = per_col * s.col_tiles;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)s.k, (cuuint64_t)s.k, (cuuint64_t)kLimbs};
  const cuuint64_t strides[2] = {(cuuint64_t)s.k, (cuuint64_t)s.k * s.k};  // bytes
  const cuuint32_t box[3] = {kChunk, kTileCols, kLimbs};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(mat), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const int smem = std::min(s.chunks, kStages) * kMatStage + kPairs * kXBuf + 1024 +
                   kStages * (8 + 4);  // stages, x buffers, alignment, barriers, counters
  const auto kernel = limb_matmul_wgmma<kLeft, kScaled>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      map, (const u32*)x, (u32*)out, (const u32*)s_tab, (const u32*)s_con, s);
  return (int)cudaGetLastError();
}

}  // namespace wg

// The dispatch by K alone: the wgmma body from K = 128, the mma.sync body
// below.
template <bool kLeft, bool kScaled>
int launch_limb_matmul(const void* mat, const void* x, void* out, const void* s_tab,
                       const void* s_con, unsigned long long q, long long batch, int k_log,
                       int f_log, void* stream) {
  if (q < 3 || q >= (1ull << (kLimbs * kLimbBits)) || batch < 1 || k_log < 0 || k_log > 12 ||
      f_log < 0 || f_log > 30)
    return (int)cudaErrorInvalidValue;
  if (k_log >= wg::kMinKLog)
    return wg::launch<kLeft, kScaled>(mat, x, out, s_tab, s_con, q, batch, k_log, f_log, stream);
  return mma_body::launch<kLeft, kScaled>(mat, x, out, s_tab, s_con, q, batch, k_log, f_log,
                                          stream);
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
