// Modular arithmetic of the negacyclic NTT at word 32 and word 64, for host
// and device: the Harvey butterflies, the fused final inverse stage, the
// Shoup multiply, the lazy reduce ladder and the variable x variable product;
// and for the radix-4 stages (K10) the dual Shoup product at words 64, 32 and
// 56 and the single product at word 56 (``Word<W>``).
//
// Device form of ntt_tpu_torch/modmath.py and kernels/elems.py, which mirror
// ntt_tpu/modmath.py and ntt_tpu/kernels/elems.py bit for bit.  The JAX
// package builds every 32x32 product from 16-bit halves and every 64-bit word
// from a (lo, hi) uint32 pair, because the TPU's vector unit has neither;
// here __umulhi / __umul64hi and the native 64-bit multiply take their place.
//
// Words are unsigned and wrap mod 2^word exactly as the reference's uint64_t
// arithmetic does.  Lazy values stay below 4q: q < 2^30 at word 32 and
// q < 2^62 at word 64 keep 4q below 2^word.
//
// The single product of the butterflies is a compile-time choice, a
// reduction policy (ShoupRed, SolinasRed) that the kernels take as a template
// argument: ShoupRed is the Shoup product, which reads each twiddle's Shoup
// constant; SolinasRed is the two-fold Solinas product of the JAX package's
// NTT_MULMOD=solinas switch (ntt_tpu.modmath.mul_mod_q2_solinas,
// mul_mod32_q2_solinas), which reads none.  The dual products, the word-56
// products and the fused final stage's second product stay Shoup under
// either, as in the JAX package.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define NTT_HD __host__ __device__ __forceinline__
#else
#define NTT_HD inline
#endif

namespace ntt {

typedef unsigned int u32;
typedef unsigned long long u64;

NTT_HD u32 mulhi(u32 a, u32 b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (u32)(((u64)a * b) >> 32);
#endif
}

NTT_HD u64 mulhi(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// v if v < kq else v - kq
template <typename T>
NTT_HD T cond_sub(T v, T kq) {
  return v < kq ? v : v - kq;
}

template <typename T>
NTT_HD T reduce_2q_to_q(T v, T q) {
  return cond_sub<T>(v, q);
}

template <typename T>
NTT_HD T reduce_4q_to_2q(T v, T q) {
  return cond_sub<T>(v, (T)(2 * q));
}

template <typename T>
NTT_HD T reduce_4q_to_q(T v, T q) {
  return reduce_2q_to_q<T>(reduce_4q_to_2q<T>(v, q), q);
}

// Radix-2 stage with groups of t = 2^lt butterflies: butterfly j of the stage
// pairs a[i0] and a[i0 + t] of group g = j / t, under twiddle index m + g.
struct StageIndex {
  int i0, i1, g;
  NTT_HD StageIndex(int j, int lt) {
    g = j >> lt;
    i0 = (g << (lt + 1)) | (j & ((1 << lt) - 1));
    i1 = i0 + (1 << lt);
  }
};

// Shoup: (w*t - hi(w_con*t)*q) mod 2^word, in [0, 2q) for t < 2^word and
// w_con = floor(w * 2^word / q).
template <typename T>
NTT_HD T shoup_mul_q2(T w, T w_con, T t, T q) {
  return (T)(w * t - mulhi(w_con, t) * q);
}

// The 32-bit pieces of the Solinas products.  funnel_r(lo, hi, s) is the low
// 32 bits of (hi:lo) >> (s mod 32), one SHF on the card; mad_wide(a, b, c) is
// a*b + c in 64 bits, one IMAD.WIDE.U32, exact wherever the sum stays below
// 2^64.
NTT_HD u32 lo32(u64 x) { return (u32)x; }
NTT_HD u32 hi32(u64 x) { return (u32)(x >> 32); }

NTT_HD u32 funnel_r(u32 lo, u32 hi, u32 s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, s);
#else
  return (u32)((((u64)hi << 32) | lo) >> (s & 31));
#endif
}

NTT_HD u64 mad_wide(u32 a, u32 b, u64 c) { return (u64)a * b + c; }

// The reduction policies of the single product w*t of a twiddle w and its
// Shoup constant w_con: mul(w, w_con, t, q) in [0, 2q).  kCon says whether
// the product reads w_con; a kernel that instantiates SolinasRed loads no
// Shoup constant of a single product.
struct ShoupRed {
  static constexpr bool kCon = true;
  template <typename T>
  NTT_HD T mul(T w, T w_con, T t, T q) const {
    return shoup_mul_q2<T>(w, w_con, t, q);
  }
};

// The two-fold Solinas product for q = 2^e - 2^k + 1, 0 < k, 2k + 3 <= e
// (ntt_tpu.modmath.mul_mod_q2_solinas at word 64, 32 < e < 63, and
// mul_mod32_q2_solinas at word 32, e <= 29), bit for bit: the product p,
// A = the low word of p >> e, the first fold r = A c + (p mod 2^e) with
// c = 2^k - 1, A2 = the low 32 bits of r >> e, and the second fold
// (r mod 2^e) + A2 c mod 2^word.  No quotient and no final subtract: in
// [0, 2q) for w < q and t < 8q (t < 4q at e = 62).  Each step is exact for
// any w, t below 2^word (A c < 2^94 at word 64, A2 c < 2^62), so the result
// is JAX's limb code's for every input.
//
// The constructor turns (e, k) into what the folds use; the kernels take
// the policy as a parameter, so these sit in the constant bank.  Bit e lies
// at bit s = e mod 32 of a 32-bit limb at both words (limb 1 of p at word
// 64, limb 0 at word 32), so every shift by e is one funnel shift by s, and
// each (x << k) - x a wide multiply by c that also adds the term beside it.
// Cost on sm_90a (python -m ntt_tpu_torch.sass): a word-64 butterfly is 29
// SASS instructions, as many as Shoup's, with 10 multiplies against 12; a
// word-32 one 13 against Shoup's 9, 3 multiplies each.  The Solinas product
// reads no Shoup constant, so it saves bytes where a kernel streams its
// twiddles.
struct SolinasRed {
  static constexpr bool kCon = false;
  u32 s;     // e mod 32: e - 32 at word 64, e at word 32
  u32 mask;  // 2^s - 1, the bits below bit e of the limb that holds it
  u32 c;     // 2^k - 1
  u32 nq;    // c - 2^s mod 2^32: -q mod 2^32 at word 32

  SolinasRed() = default;
  NTT_HD SolinasRed(int e, int k)
      : s((u32)e & 31), mask((1u << (e & 31)) - 1), c((1u << k) - 1),
        nq(((1u << k) - 1) - (1u << (e & 31))) {}

  // Word 64 on 32-bit limbs: p = w t once, as limbs p0..p3 (ptxas makes the
  // 128-bit product four wide products and their carries, fewer
  // instructions than the same sums written on 32-bit limbs); A = (a0, a1),
  // B = p mod 2^e; r = A c + B as lo32(x) + 2^32 r12 (x = a0 c + B < 2^63,
  // r12 = a1 c + hi32(x)).
  NTT_HD u64 mul(u64 w, u64, u64 t, u64) const {
    const unsigned __int128 p = (unsigned __int128)w * t;
    const u64 lo = (u64)p, hi = (u64)(p >> 64);
    const u32 p1 = hi32(lo), p2 = lo32(hi), p3 = hi32(hi);
    const u32 a0 = funnel_r(p1, p2, s), a1 = funnel_r(p2, p3, s);
    const u64 x = mad_wide(a0, c, ((u64)(p1 & mask) << 32) | lo32(lo));
    const u64 r12 = mad_wide(a1, c, hi32(x));
    const u32 a2 = funnel_r(lo32(r12), hi32(r12), s);
    return mad_wide(a2, c, ((u64)(lo32(r12) & mask) << 32) | lo32(x));
  }

  // Word 32: p = w t, A = the low 32 bits of p >> e, r = A c + (p mod 2^e)
  // < 2^46, then (r mod 2^e) + A2 c mod 2^32, which is r - A2 q mod 2^32
  // (r mod 2^e = r - (A2 << e) mod 2^32, as e < 32): one multiply-add and
  // no mask.
  NTT_HD u32 mul(u32 w, u32, u32 t, u32) const {
    const u64 p = mad_wide(w, t, 0);
    const u32 a = funnel_r(lo32(p), hi32(p), s);
    const u64 r = mad_wide(a, c, lo32(p) & mask);
    const u32 a2 = funnel_r(lo32(r), hi32(r), s);
    return lo32(r) + a2 * nq;
  }
};

// Dual Shoup product t1*w1 + t2*w2 with ONE quotient, the high word of the
// 128-bit sum c1*t1 + c2*t2 (ntt_tpu.modmath.shoup_dbl_mul_q2): in [0, 2q)
// for t1 + t2 within the radix-4 bound.  Two separate products would give
// other lazy representatives than the reference's.
NTT_HD u64 shoup_dbl_mul_q2(u64 w1, u64 c1, u64 w2, u64 c2, u64 t1, u64 t2, u64 q) {
  const u64 lo1 = c1 * t1;
  const u64 lo = lo1 + c2 * t2;
  const u64 big_q = mulhi(c1, t1) + mulhi(c2, t2) + (lo < lo1 ? 1 : 0);
  return w1 * t1 + w2 * t2 - big_q * q;
}

// At word 32 the quotient is bits 32..63 of the 64-bit sum; its carry out of
// bit 64 does not reach Q*q mod 2^32 (ntt_tpu.kernels.radix4._shoup_dbl32_q2).
NTT_HD u32 shoup_dbl_mul_q2(u32 w1, u32 c1, u32 w2, u32 c2, u32 t1, u32 t2, u32 q) {
  const u32 big_q = (u32)(((u64)c1 * t1 + (u64)c2 * t2) >> 32);
  return w1 * t1 + w2 * t2 - big_q * q;
}

// Word 56, the s390x VMSL form (ntt_tpu.modmath.shoup_mul56_q2 /
// shoup_dbl_mul56_q2): w_con = floor(w * 2^56 / q) and the quotient is bits
// 56..119 of the 128-bit product (or of the sum of two).
NTT_HD u64 shr128_56(u64 lo, u64 hi) { return (hi << 8) | (lo >> 56); }

NTT_HD u64 shoup_mul56_q2(u64 w, u64 w_con, u64 t, u64 q) {
  return w * t - shr128_56(w_con * t, mulhi(w_con, t)) * q;
}

NTT_HD u64 shoup_dbl_mul56_q2(u64 w1, u64 c1, u64 w2, u64 c2, u64 t1, u64 t2, u64 q) {
  const u64 lo1 = c1 * t1;
  const u64 lo = lo1 + c2 * t2;
  const u64 hi = mulhi(c1, t1) + mulhi(c2, t2) + (lo < lo1 ? 1 : 0);
  return w1 * t1 + w2 * t2 - shr128_56(lo, hi) * q;
}

// The Shoup products of one word: the storage type T, mul (one product) and
// dbl (the dual product).
template <int W>
struct Word;

template <>
struct Word<32> {
  typedef u32 T;
  static NTT_HD u32 mul(u32 w, u32 c, u32 t, u32 q) { return shoup_mul_q2<u32>(w, c, t, q); }
  static NTT_HD u32 dbl(u32 w1, u32 c1, u32 w2, u32 c2, u32 t1, u32 t2, u32 q) {
    return shoup_dbl_mul_q2(w1, c1, w2, c2, t1, t2, q);
  }
};

template <>
struct Word<64> {
  typedef u64 T;
  static NTT_HD u64 mul(u64 w, u64 c, u64 t, u64 q) { return shoup_mul_q2<u64>(w, c, t, q); }
  static NTT_HD u64 dbl(u64 w1, u64 c1, u64 w2, u64 c2, u64 t1, u64 t2, u64 q) {
    return shoup_dbl_mul_q2(w1, c1, w2, c2, t1, t2, q);
  }
};

template <>
struct Word<56> {
  typedef u64 T;
  static NTT_HD u64 mul(u64 w, u64 c, u64 t, u64 q) { return shoup_mul56_q2(w, c, t, q); }
  static NTT_HD u64 dbl(u64 w1, u64 c1, u64 w2, u64 c2, u64 t1, u64 t2, u64 q) {
    return shoup_dbl_mul56_q2(w1, c1, w2, c2, t1, t2, q);
  }
};

// Harvey forward butterfly: inputs < 4q, outputs < 4q.
template <typename T, class Red = ShoupRed>
NTT_HD void fwd_bfly(T& x, T& y, T w, T w_con, T q, Red red = Red()) {
  const T x1 = reduce_4q_to_2q<T>(x, q);
  const T t = red.mul(w, w_con, y, q);
  x = (T)(x1 + t);
  y = (T)(x1 + 2 * q - t);
}

// Harvey inverse (Gentleman-Sande) butterfly: inputs < 2q, outputs < 2q.
template <typename T, class Red = ShoupRed>
NTT_HD void bkw_bfly(T& x, T& y, T w, T w_con, T q, Red red = Red()) {
  const T s = reduce_4q_to_2q<T>((T)(x + y), q);
  const T d = (T)(x + 2 * q - y);
  x = s;
  y = red.mul(w, w_con, d, q);
}

// Constants of the fused final inverse stage.  con = con_lo + con_hi * 2^word
// is the Shoup constant of tmp = n_inv * w_inv[1] (lazy, < 2q), which can be
// one bit wider than the word: its top bit adds t to the quotient.
template <typename T>
struct FinalConsts {
  T n_inv, n_inv_con, tmp, con_lo;
  int con_hi;
};

// Final inverse stage with n^-1 fused (src/ntt_reference.c:55-65 of the
// reference); strict outputs.  Red reduces the n^-1 product; the second
// product keeps its own quotient from con, under either policy.
template <typename T, class Red = ShoupRed>
NTT_HD void bkw_final(T& x, T& y, const FinalConsts<T>& f, T q, Red red = Red()) {
  const T x1 = (T)(x + y);
  const T t = (T)(x + 2 * q - y);
  const T nx = reduce_2q_to_q<T>(red.mul(f.n_inv, f.n_inv_con, x1, q), q);
  T big_q = mulhi(f.con_lo, t);
  if (f.con_hi) big_q = (T)(big_q + t);
  x = nx;
  y = reduce_2q_to_q<T>((T)(f.tmp * t - big_q * q), q);
}

// Variable x variable (a * b) mod q for a, b < q, strict output: the
// algorithm of ntt_tpu.modmath.mul_mod_q32 / mul_mod_q, whose constants the
// host computes once per q.
struct MulModConsts32 {
  u32 q, c, c_con, mu;  // c = 2^32 mod q, c_con its Shoup constant, mu = 2^32 / q
};

NTT_HD u32 mul_mod(u32 a, u32 b, const MulModConsts32& k) {
  const u64 p = (u64)a * b;
  const u32 lo = (u32)p;
  const u32 hi = (u32)(p >> 32);
  const u32 t = shoup_mul_q2<u32>(k.c, k.c_con, hi, k.q);  // < 2q
  u32 r = lo - mulhi(k.mu, lo) * k.q;                      // Barrett, < 3q
  r = reduce_2q_to_q<u32>(reduce_4q_to_2q<u32>(r, k.q), k.q);
  r = t + r;  // < 3q
  return reduce_2q_to_q<u32>(reduce_4q_to_2q<u32>(r, k.q), k.q);
}

struct MulModConsts64 {
  u64 q;
  u64 c[4], c_con[4];  // c[k] = 2^(32k) mod q and its Shoup constant, k = 1..3
  u64 mu;              // 2^32 / q, used when q < 2^31
};

NTT_HD u64 mul_mod(u64 a, u64 b, const MulModConsts64& k) {
  const u64 q = k.q;
  const u64 lo = a * b;
  const u64 hi = mulhi(a, b);
  const u64 f3 = shoup_mul_q2<u64>(k.c[3], k.c_con[3], hi >> 32, q);
  const u64 f2 = shoup_mul_q2<u64>(k.c[2], k.c_con[2], hi & 0xFFFFFFFFull, q);
  const u64 f1 = shoup_mul_q2<u64>(k.c[1], k.c_con[1], lo >> 32, q);
  u64 acc = reduce_4q_to_2q<u64>(f3 + f2, q);
  acc = reduce_4q_to_2q<u64>(acc + f1, q);
  u64 p0 = lo & 0xFFFFFFFFull;
  if (q < (1ull << 31)) {
    const u64 r = p0 - ((p0 * k.mu) >> 32) * q;  // < 3q
    p0 = reduce_2q_to_q<u64>(reduce_4q_to_2q<u64>(r, q), q);
  } else if (q < (1ull << 32)) {
    p0 = reduce_2q_to_q<u64>(p0, q);
  }
  acc = reduce_4q_to_2q<u64>(acc + p0, q);  // acc + p0 < 3q
  return reduce_2q_to_q<u64>(acc, q);
}

}  // namespace ntt
