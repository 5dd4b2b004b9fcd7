// K8: the twist of the two-level six-step ("sixstep-rec"), at word 32 and
// word 64.
//
// Replaces ntt_tpu/kernels/sixstep.py:465 _twist_mul (XLA code on the TPU,
// not Pallas).  With N = N1 * N2 viewed (N1, N2), word n2 = h * LO + l of row
// c is multiplied by gamma_c^n2 = A[c, h] * B[c, l] between the level-1
// transform of the columns and the level-2 transform of the rows, as two
// chained Shoup products in this order:
//
//   v   = shoup(A[c, h], Ac[c, h], x)
//   out = shoup(B[c, l], Bc[c, l], v)
//
// Inputs < 4q, outputs < 2q.  One product by a premultiplied T[c, n2] would
// give other lazy representatives than the reference's, so the two stay.
// A is (N1, HI) and B (N1, LO) with LO = 2^ceil(l2 / 2), HI = N2 / LO: 8.4 MB
// of tables with their constants at N = 2^24, word 64, where a full twist
// table would be 256 MB.
//
// What bounds it on an H100: device memory.  Each word is read and written
// once (2 x 128 MB at N = 2^24, word 64) for two Shoup products (20 32-bit
// multiplies at word 64, 6 at word 32); the tables stay in L2.  Design: a
// grid-stride loop in which each thread moves 16 consecutive bytes (4 words
// at word 32, 2 at word 64) with one vector load and one vector store, so a
// warp moves 512 contiguous bytes; each word finds its A and B entries by
// shifts and masks and reads them through the read-only cache, where the
// neighbouring threads of a warp read the same or neighbouring entries.
// Fusing the twist into the level-2 transform's first load would save a
// pass over device memory; that is later work.  Under the NTT_MULMOD=solinas
// switch both chained products take the Solinas form (the SolinasRed
// instantiation of modarith.cuh), which reads neither Ac nor Bc.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt {

constexpr int kTwistThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Words {
  T w[V];
};

// Geometry of a launch: N = 2^m words a polynomial, rows of N2 = 2^l2 words,
// LO = 2^lo_log words of B a row; `count` vectors of V words in all.
struct TwistShape {
  long long count;
  int m, l2, lo_log;
};

template <typename T, int V, class Red>
__global__ void __launch_bounds__(kTwistThreads)
twist_mul_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ a_tab,
                 const T* __restrict__ a_con, const T* __restrict__ b_tab,
                 const T* __restrict__ b_con, T q, TwistShape s, Red red) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_mask = (1ll << s.m) - 1;
  const int n2_mask = (1 << s.l2) - 1, lo_mask = (1 << s.lo_log) - 1;
  const int hi_log = s.l2 - s.lo_log;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < s.count;
       i += stride) {
    Words<T, V> v = reinterpret_cast<const Words<T, V>*>(in)[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int p = (int)((i * V + k) & n_mask);  // position in the polynomial
      const int c = p >> s.l2, n2 = p & n2_mask;
      const int ai = (c << hi_log) | (n2 >> s.lo_log);
      const int bi = (c << s.lo_log) | (n2 & lo_mask);
      const T ac = Red::kCon ? __ldg(a_con + ai) : 0, bc = Red::kCon ? __ldg(b_con + bi) : 0;
      const T x = red.mul(__ldg(a_tab + ai), ac, v.w[k], q);
      v.w[k] = red.mul(__ldg(b_tab + bi), bc, x, q);
    }
    reinterpret_cast<Words<T, V>*>(out)[i] = v;
  }
}

template <typename T, int V, class Red>
int launch_twist(const void* in, void* out, const void* a, const void* ac, const void* b,
                 const void* bc, T q, TwistShape s, void* stream, Red red) {
  long long blocks = (s.count + kTwistThreads - 1) / kTwistThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  twist_mul_kernel<T, V, Red><<<(unsigned)blocks, kTwistThreads, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const T*)a, (const T*)ac, (const T*)b, (const T*)bc, q, s, red);
  return (int)cudaGetLastError();
}

// 16-byte vectors where the words divide into them and both pointers are
// aligned (every tensor the wrapper allocates is); single words otherwise.
template <typename T, class Red = ShoupRed>
int launch_twist_mul(const void* in, void* out, const void* a, const void* ac, const void* b,
                     const void* bc, unsigned long long q, int batch, int m, int l1_log,
                     void* stream, Red red = Red()) {
  if (batch < 1 || m < 1 || m > 30 || l1_log < 0 || l1_log > m)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  TwistShape s;
  s.m = m;
  s.l2 = m - l1_log;
  s.lo_log = (s.l2 + 1) / 2;
  const long long words = (long long)batch << m;
  if (words % V == 0 && ((uintptr_t)in | (uintptr_t)out) % 16 == 0) {
    s.count = words / V;
    return launch_twist<T, V>(in, out, a, ac, b, bc, (T)q, s, stream, red);
  }
  s.count = words;
  return launch_twist<T, 1>(in, out, a, ac, b, bc, (T)q, s, stream, red);
}

}  // namespace ntt

// Plain C interface (see ntt_fused.cu): in and out (batch, N1, N2), the
// tables A, Ac (N1, HI) and B, Bc (N1, LO) at the word of the entry point.
extern "C" {

int ntt_twist_mul_u32(const void* in, void* out, const void* a, const void* ac, const void* b,
                      const void* bc, unsigned long long q, int batch, int m, int l1_log,
                      void* stream) {
  return ntt::launch_twist_mul<ntt::u32>(in, out, a, ac, b, bc, q, batch, m, l1_log, stream);
}

int ntt_twist_mul_u64(const void* in, void* out, const void* a, const void* ac, const void* b,
                      const void* bc, unsigned long long q, int batch, int m, int l1_log,
                      void* stream) {
  return ntt::launch_twist_mul<ntt::u64>(in, out, a, ac, b, bc, q, batch, m, l1_log, stream);
}

// The SolinasRed instantiations: (e, k) before the stream; ac and bc are not
// read (they may be null).
int ntt_twist_mul_solinas_u32(const void* in, void* out, const void* a, const void* ac,
                              const void* b, const void* bc, unsigned long long q, int batch,
                              int m, int l1_log, int e, int k, void* stream) {
  return ntt::launch_twist_mul<ntt::u32>(in, out, a, ac, b, bc, q, batch, m, l1_log, stream,
                                         ntt::SolinasRed{e, k});
}

int ntt_twist_mul_solinas_u64(const void* in, void* out, const void* a, const void* ac,
                              const void* b, const void* bc, unsigned long long q, int batch,
                              int m, int l1_log, int e, int k, void* stream) {
  return ntt::launch_twist_mul<ntt::u64>(in, out, a, ac, b, bc, q, batch, m, l1_log, stream,
                                         ntt::SolinasRed{e, k});
}

}  // extern "C"
