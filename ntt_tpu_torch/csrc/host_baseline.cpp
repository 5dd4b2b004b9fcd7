// The bench's host baseline: a single-core Shoup-lazy radix-2 forward NTT
// on the CPU, and its timing protocol (10 warm-up transforms, then `reps`
// repetitions of `inner` transforms, the minimum per-transform mean, on
// CLOCK_MONOTONIC).  The port's own copy of the part of the JAX package's
// host core (csrc/ntt_core.cpp: powmod, the power and word-64 Shoup tables,
// nttcore_fwd_lazy64, nttcore_bench_fwd_lazy64) that the bench's
// vs_baseline needs, with the same bits and the same protocol.
//
// Built by ntt_tpu_torch/host_baseline.py with g++ into a shared library
// with a plain C interface, loaded with ctypes.  No CUDA: nvcc never sees
// this file (native.py builds only csrc/*.cu).

#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace {

inline u64 mulmod(u64 a, u64 b, u64 q) { return (u64)((u128)a * b % q); }

std::vector<u64> bitrev_indices(u64 n) {
  std::vector<u64> rev(n, 0);
  for (u64 i = 1; i < n; ++i) rev[i] = (rev[i >> 1] >> 1) | ((i & 1) ? (n >> 1) : 0);
  return rev;
}

// Bit-reversed powers root^0 .. root^(n-1) mod q.
void power_table(u64 root, u64 n, u64 q, u64* out) {
  auto rev = bitrev_indices(n);
  u64 cur = 1;
  for (u64 i = 0; i < n; ++i) {
    out[rev[i]] = cur;
    cur = mulmod(cur, root, q);
  }
}

// Word-64 Shoup constants floor(v * 2^64 / q).
void shoup_table(const u64* vals, u64 n, u64 q, u64* out) {
  for (u64 i = 0; i < n; ++i) out[i] = (u64)(((u128)vals[i] << 64) / q);
}

// Lazy Shoup product w * t mod q, below 2q.
inline u64 shoup_mul(u64 w, u64 w_con, u64 t, u64 q) {
  u64 approx = (u64)(((u128)w_con * t) >> 64);
  return w * t - approx * q;
}

double now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e9 + ts.tv_nsec;
}

}  // namespace

extern "C" {

// In-place forward negacyclic NTT of a[0..n) (values below q): natural
// order in, bit-reversed out; values stay below 4q, and with strict are
// reduced to [0, q) at the end.  w / w_con: the bit-reversed power table
// of the 2n-th root and its word-64 Shoup constants.
void host_fwd_lazy64(u64* a, u64 n, u64 q, const u64* w, const u64* w_con, int strict) {
  u64 twoq = 2 * q;
  for (u64 half = n >> 1, block = 1; half >= 1; half >>= 1, block <<= 1) {
    for (u64 b = 0; b < block; ++b) {
      u64 tw = w[block + b], tw_con = w_con[block + b];
      u64* lo = a + 2 * b * half;
      u64* hi = lo + half;
      for (u64 j = 0; j < half; ++j) {
        u64 x = lo[j];
        if (x >= twoq) x -= twoq;
        u64 prod = shoup_mul(tw, tw_con, hi[j], q);
        lo[j] = x + prod;
        hi[j] = x + twoq - prod;
      }
    }
  }
  if (strict) {
    for (u64 i = 0; i < n; ++i) {
      u64 v = a[i];
      if (v >= twoq) v -= twoq;
      if (v >= q) v -= q;
      a[i] = v;
    }
  }
}

// Nanoseconds per lazy forward transform at N = 2^m: the tables of root,
// a fixed input, 10 warm-up transforms, then the minimum over reps of the
// mean of inner transforms (each on a fresh copy of the input).
double host_bench_fwd_lazy64(u64 m, u64 q, u64 root, int inner, int reps) {
  u64 n = 1ull << m;
  std::vector<u64> w(n), w_con(n), a(n), scratch(n);
  power_table(root, n, q, w.data());
  shoup_table(w.data(), n, q, w_con.data());
  for (u64 i = 0; i < n; ++i) a[i] = (0x9E3779B97F4A7C15ull * (i + 1)) % q;

  for (int i = 0; i < 10; ++i) {
    std::memcpy(scratch.data(), a.data(), n * sizeof(u64));
    host_fwd_lazy64(scratch.data(), n, q, w.data(), w_con.data(), 0);
  }
  double best = 1e30;
  for (int r = 0; r < reps; ++r) {
    double t0 = now_ns();
    for (int i = 0; i < inner; ++i) {
      std::memcpy(scratch.data(), a.data(), n * sizeof(u64));
      host_fwd_lazy64(scratch.data(), n, q, w.data(), w_con.data(), 0);
    }
    double per = (now_ns() - t0) / inner;
    if (per < best) best = per;
  }
  return best;
}

}  // extern "C"
