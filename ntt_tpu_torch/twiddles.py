"""Twiddle tables of one (q, m) instance, host-side, exact.

The port's own copy of the tables it reads from ``ntt_tpu/twiddles.py``:
the bit-reversed powers of the root and of its inverse, their Shoup
constants at a given word size (64, 56 or 32), the Shoup constant of
n^-1, the factored twist tables of the two-level six-step, and the
expanded layouts of the reference's variant families (``expand_w``,
``expand_w_hexl``, ``expand_w_r4``, ``expand_w_r4r2``,
``expand_w_r2_16``), and the 'mxu' variant's limb matrices and twiddle /
scale tables (``mxu_tables``).  The
values are those of the JAX package's builders, computed exactly in
vectorised uint64 arithmetic (the powers as a (sqrt N x sqrt N) grid of
Shoup products, the Shoup constants in two 32-bit quotient digits), so a
table of N = 2^24 takes seconds, not the minute of a Python loop.  Every
table is numpy uint64.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np


def bit_rev_perm(n: int) -> np.ndarray:
    """Permutation p with p[i] = bitrev(i) over log2(n) bits (int64), by
    doubling: p of 2n words is (2 p, 2 p + 1) of n words."""
    p = np.zeros(1, dtype=np.int64)
    while len(p) < n:
        p = np.concatenate([2 * p, 2 * p + 1])
    return p


Q_LIMIT = 1 << 62  # every q the port takes is below it
_U32 = np.uint64(32)
_LOW32 = np.uint64(0xFFFFFFFF)


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of the 128-bit products of uint64 arrays (broadcast),
    from 32-bit halves."""
    a0, a1, b0, b1 = a & _LOW32, a >> _U32, b & _LOW32, b >> _U32
    lh, hl = a0 * b1, a1 * b0
    carry = (((a0 * b0) >> _U32) + (lh & _LOW32) + (hl & _LOW32)) >> _U32
    return a1 * b1 + (lh >> _U32) + (hl >> _U32) + carry


def _quotient_digit(z: np.ndarray, q: int, bits: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """(floor(z * 2^bits / q), z * 2^bits mod q) for uint64 z < q < 2^62 and
    bits <= 32: a float64 estimate, off by at most one, corrected by the
    exact remainder, which lies in [-q, 2q) and so fits int64 (wrapping
    uint64 products)."""
    qu = np.uint64(q)
    d = np.floor(z.astype(np.float64) * 2.0**bits / float(q)).astype(np.uint64)
    r = ((z << np.uint64(bits)) - d * qu).view(np.int64)
    low = r < 0
    d, r = np.where(low, d - np.uint64(1), d), np.where(low, r + np.int64(q), r)
    high = r >= np.int64(q)
    d, r = np.where(high, d + np.uint64(1), d), np.where(high, r - np.int64(q), r)
    return d, r.view(np.uint64)


def powers(base: int, n: int, q: int) -> np.ndarray:
    """base^i mod q for i in [0, n), n a power of two, q < 2^62: Shoup
    products of base^(kB) by base^j (j < B, B about sqrt n)."""
    cols = 1 << ((n.bit_length() - 1 + 1) // 2)
    rows = n // cols
    small = [1] * cols
    for j in range(1, cols):
        small[j] = small[j - 1] * base % q
    big = [1] * rows
    step = small[-1] * base % q  # base^cols
    for k in range(1, rows):
        big[k] = big[k - 1] * step % q
    qu = np.uint64(q)
    s = np.array(small, dtype=np.uint64)[None, :]
    s_con = np.array([(x << 64) // q for x in small], dtype=np.uint64)[None, :]
    g = np.array(big, dtype=np.uint64)[:, None]
    r = s * g - _mulhi64(s_con, g) * qu  # in [0, 2q)
    return np.where(r >= qu, r - qu, r).reshape(n)


def calc_w(w: int, n: int, q: int) -> np.ndarray:
    """Bit-reversed table of w^i mod q, i in [0, N): out[bitrev(i)] = w^i."""
    return powers(w, n, q)[bit_rev_perm(n)]  # bit reversal is its own inverse


def calc_w_inv(w_inv: int, n: int, q: int) -> np.ndarray:
    """The same table for the inverse root."""
    return calc_w(w_inv, n, q)


def _con_digits(x: np.ndarray, q: int, word_size: int) -> np.ndarray:
    hi, rem = _quotient_digit(x, q)
    if word_size == 32:
        return hi
    lo_bits = word_size - 32
    lo, _ = _quotient_digit(rem, q, lo_bits)
    return (hi << np.uint64(lo_bits)) | lo


PARALLEL_MIN = 1 << 20  # tables from this many entries are split over threads


def calc_w_con(w_tab: np.ndarray, q: int, word_size: int = 64) -> np.ndarray:
    """Shoup constants floor(w_i * 2^word_size / q) of a table (word_size
    64; 56 for the word-56 radix-4 variant; 32 for the word-32 path, where
    they fit 32 bits for q < 2^30); entries below q < 2^62, the port's
    limit (the lazy butterflies keep values below 4q < 2^64).  A table of
    PARALLEL_MIN entries or more is computed in slices on a thread each
    (numpy lets go of the GIL in its loops): the 5N tables at N = 2^24."""
    if q >= Q_LIMIT:
        raise ValueError(f"q = {q:#x} is not below 2^62")
    if word_size not in (32, 56, 64):
        raise ValueError(f"word_size must be 32, 56 or 64, got {word_size}")
    x = np.asarray(w_tab, dtype=np.uint64)
    flat = x.ravel()
    threads = min(os.cpu_count() or 1, flat.size // (PARALLEL_MIN // 4))
    if flat.size < PARALLEL_MIN or threads < 2:
        return _con_digits(flat, q, word_size).reshape(x.shape)
    out = np.empty_like(flat)
    bounds = np.linspace(0, flat.size, threads + 1).astype(np.int64)

    def part(i: int) -> None:
        out[bounds[i]:bounds[i + 1]] = _con_digits(flat[bounds[i]:bounds[i + 1]], q, word_size)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(part, range(threads)))
    return out.reshape(x.shape)


def calc_ninv_con(n_inv: int, q: int, word_size: int = 64) -> int:
    """The Shoup constant of n^-1."""
    return (n_inv << word_size) // q


def _power_rows(bases: np.ndarray, count: int, q: int) -> np.ndarray:
    """(len(bases), count) table of bases[c]^j mod q, j < count: column j is
    the Shoup product of column j - 1 by bases[c] (bases < q < 2^62)."""
    qu = np.uint64(q)
    cons = calc_w_con(bases, q, 64)
    out = np.empty((bases.size, count), dtype=np.uint64)
    cur = np.ones(bases.size, dtype=np.uint64)
    for j in range(count):
        out[:, j] = cur
        r = bases * cur - _mulhi64(cons, cur) * qu  # in [0, 2q)
        cur = np.where(r >= qu, r - qu, r)
    return out


def twist_tables_rec(psi: int, q: int, n: int, l1_log: int):
    """Factored twist tables of the two-level six-step
    (``ntt_tpu.twiddles.twist_tables_rec``): with N = N1 * N2 viewed
    (N1, N2), row c of the level-1 output is twisted by gamma_c^n2 before
    the size-N2 transform of the rows, gamma_c = psi^((2 rev(c) + 1 - N1)
    mod 2N), rev over l1_log bits.  Returns uint64 A of shape (N1, HI) and B
    of shape (N1, LO), LO = 2^ceil(l2 / 2), HI * LO = N2, with
    A[c, h] * B[c, l] = gamma_c^(h LO + l).  Pass psi = w for the forward
    twist and psi = w_inv for the inverse.  Vectorised: one pow a row, then
    LO + HI Shoup products over all rows at once."""
    logn = n.bit_length() - 1
    n1, l2 = 1 << l1_log, logn - l1_log
    lo_log = (l2 + 1) // 2
    lo, hi = 1 << lo_log, 1 << (l2 - lo_log)
    # signed numpy %: the exponent is negative before the reduction mod 2N
    exps = (2 * bit_rev_perm(n1) + 1 - n1) % (2 * n)
    gamma = np.array([pow(psi, int(e), q) for e in exps], dtype=np.uint64)
    gamma_lo = np.array([pow(psi, int(e) * lo % (2 * n), q) for e in exps], dtype=np.uint64)
    return _power_rows(gamma_lo, hi, q), _power_rows(gamma, lo, q)


# ---------------------------------------------------------------------------
# Expanded layouts of the reference's variant families
# (``ntt_tpu/twiddles.py:76-327``), in vectorised uint64 arithmetic: each
# loop of the JAX builders over table entries becomes one gather of index
# arrays, so the entries (and any entry a small N makes them read out of
# range) are the same.
# ---------------------------------------------------------------------------

# The canonical emission orders of the SIMD layouts: permute_w's 8-lane
# shuffle, and the FwdT2 order of each group of 4 (each entry twice).
LANE_PERM = np.array([0, 4, 1, 5, 2, 6, 3, 7])
T2_GROUP_ORDER = np.array([0, 2, 1, 3])


def mul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """(a * b) mod q element-wise for uint64 a, b < q < 2^62: a Shoup
    product with a's exact constant, then one conditional subtract."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    qu = np.uint64(q)
    r = a * b - _mulhi64(calc_w_con(a, q, 64), b) * qu  # in [0, 2q)
    return np.where(r >= qu, r - qu, r)


def expand_w(w_tab: np.ndarray, q: int) -> np.ndarray:
    """The radix-4 table of 2N entries (``ntt_tpu.twiddles.expand_w``):
    slot 2i holds w[i]; from i = 2 on, slot 4k + 1 holds w[k] * w[2k] and
    slot 4k + 3 holds q - w[k] * w[2k + 1] (mod q); slots 1 and 3 are 0."""
    w = np.asarray(w_tab, dtype=np.uint64)
    n = w.shape[0]
    out = np.zeros(2 * n, dtype=np.uint64)
    out[0::2] = w
    k = np.arange(1, n // 2)
    out[4 * k + 1] = mul_mod(w[k], w[2 * k], q)
    out[4 * k + 3] = np.uint64(q) - mul_mod(w[k], w[2 * k + 1], q)
    return out


def expand_w_hexl(w_tab: np.ndarray) -> np.ndarray:
    """The HEXL layout, 13N/8 entries of a 2N table
    (``ntt_tpu.twiddles.expand_w_hexl``): [0, N/8) as it is, [N/8, N/4)
    each entry 4 times, [N/4, N/2) each twice, [N/2, N) as it is."""
    w = np.asarray(w_tab, dtype=np.uint64)
    n = w.shape[0]
    out = np.zeros(2 * n, dtype=np.uint64)
    idx = 0
    out[idx : idx + n // 8] = w[: n // 8]
    idx += n // 8
    out[idx : idx + n // 2] = np.repeat(w[n // 8 : n // 4], 4)
    idx += n // 2
    out[idx : idx + n // 2] = np.repeat(w[n // 4 : n // 2], 2)
    idx += n // 2
    out[idx : idx + n // 2] = w[n // 2 :]
    return out


def _quintuples(w: np.ndarray, heads: np.ndarray, q: int) -> np.ndarray:
    """(len(heads), 5): the five twiddles {w1, w2, w1 w2, w3, -(w1 w3)} of
    each head index (``ntt_tpu.twiddles._quintuple``)."""
    w1, w2, w3 = w[heads], w[2 * heads], w[2 * heads + 1]
    return np.stack([w1, w2, mul_mod(w1, w2, q), w3,
                     np.uint64(q) - mul_mod(w1, w3, q)], axis=1)


def _quintuple_runs(w: np.ndarray, out: np.ndarray, q: int, new_idx: int, w_idx: int,
                    m: int, limit: int) -> tuple[int, int, int]:
    """The flat quintuple runs of the radix-4 layouts: while the head index
    w_idx (= m) is below limit, the m quintuples of heads [m, 2m), then
    m *= 4.  Returns (new_idx, w_idx, m) after the last run."""
    while w_idx < limit:
        run = _quintuples(w, np.arange(w_idx, w_idx + m), q)
        out[new_idx : new_idx + 5 * m] = run.reshape(-1)
        new_idx += 5 * m
        w_idx = 4 * m
        m <<= 2
    return new_idx, w_idx, m


def r4_vec_regions(n: int) -> dict[int, tuple[int, int]]:
    """The radix-4 stages of the vector layout, m -> (L, offset): stage m
    (m groups) reads its quintuples at ``offset`` of ``expand_w_r4``, in
    blocks of 2^L groups (L = 0 in FWD8, 1 in FWD4, 3 in FWD1); the
    region map of ``ntt_tpu.kernels.radix4._r4_vec_offsets`` (n >= 256)."""
    if (n.bit_length() - 1) % 2 == 0:
        idx, m = 1, 1
    else:
        idx, m = 2, 2  # entry 1: the leading radix-2 twiddle
    out = {}
    while m < (n >> 5):
        out[m] = (0, idx)
        idx += 5 * m
        m <<= 2
    out[m] = (1, idx)
    idx = (((idx + 5 * m) >> 3) << 3) + 8
    out[m << 2] = (3, idx)
    return out


def unorder_r4(tab: np.ndarray, n: int) -> np.ndarray:
    """An ordered ``expand_w_r4`` table (or its Shoup constants) turned into
    the unordered one: the FWD1 region's lanes in LANE_PERM order."""
    m, (_, idx) = max(r4_vec_regions(n).items())
    out = np.array(tab, dtype=np.uint64)
    region = out[idx : idx + 5 * m].reshape(m // 8, 5, 8)
    out[idx : idx + 5 * m] = region[:, :, LANE_PERM].reshape(-1)
    return out


def expand_w_r4(w_tab: np.ndarray, q: int, unordered: bool = False) -> np.ndarray:
    """The vector radix-4 table, 5N entries (``ntt_tpu.twiddles.expand_w_r4``):
    for odd log2 N the leading radix-2 twiddle w[1] at entry 1; the FWD8
    region (one quintuple a group while the head index is below N/32); the
    FWD4 region (heads N/16 to N/8 in pairs, 10 entries a pair, the pair's
    entries interleaved); then, from the next multiple of 8, the FWD1
    region (heads N/4 to N/2, 8 at a time as five 8-lane vectors, lanes in
    LANE_PERM order when unordered)."""
    w = np.asarray(w_tab, dtype=np.uint64)
    n = w.shape[0]
    out = np.zeros(5 * n, dtype=np.uint64)
    if (n.bit_length() - 1) % 2 == 0:
        new_idx, w_idx, m = 1, 1, 1
    else:
        out[1] = w[1]
        new_idx, w_idx, m = 2, 2, 2
    new_idx, _, _ = _quintuple_runs(w, out, q, new_idx, w_idx, m, n >> 5)
    heads = np.arange(n >> 4, n >> 3, 2)
    a, b = _quintuples(w, heads, q), _quintuples(w, heads + 1, q)
    pairs = np.stack([a, b], axis=2)  # (pairs, 5, 2): the 10 entries of a pair
    out[new_idx : new_idx + pairs.size] = pairs.reshape(-1)
    new_idx += pairs.size
    new_idx = ((new_idx >> 3) << 3) + 8
    heads = np.arange(n >> 2, n >> 1, 8)
    blocks = _quintuples(w, (heads[:, None] + np.arange(8)).reshape(-1), q)
    blocks = blocks.reshape(len(heads), 8, 5).transpose(0, 2, 1)  # (blocks, 5, 8 lanes)
    if unordered:
        blocks = blocks[:, :, LANE_PERM]
    out[new_idx : new_idx + blocks.size] = blocks.reshape(-1)
    return out


def r4r2_regions(n: int) -> tuple[dict[int, int], list[tuple[str, int, int]]]:
    """The stages of the r4r2 layout (``ntt_tpu.kernels.mixed._r4r2_offsets``,
    n >= 128): {m: offset} of the radix-4 stages' flat quintuple runs, and
    the radix-2 tail's (kind, m, offset) in order: "r2" (even log2 N only,
    as it is), "r2x4" (each entry 4 times), "r2t2" (FwdT2 order), "r2t1"
    (FwdT1 order)."""
    idx, m, r4 = 1, 1, {}
    while m < (n >> 4):
        r4[m] = idx
        idx += 5 * m
        m <<= 2
    idx = ((idx >> 3) << 3) + 8
    tail = []
    if (n.bit_length() - 1) % 2 == 0:
        tail.append(("r2", n >> 4, idx))
        idx += n >> 4
    tail.append(("r2x4", n >> 3, idx))
    idx += 4 * (n >> 3)
    tail.append(("r2t2", n >> 2, idx))
    idx += n >> 1
    tail.append(("r2t1", n >> 1, idx))
    return r4, tail


def _t2_entries(w: np.ndarray, t: int) -> np.ndarray:
    """The FwdT2 segment: for each group of 4 from w[t], the entries in
    T2_GROUP_ORDER, each twice."""
    i = np.arange(0, t, 4)
    return np.repeat(w[t + i[:, None] + T2_GROUP_ORDER].reshape(-1), 2)


def _t1_entries(w: np.ndarray, t: int) -> np.ndarray:
    """The FwdT1 segment: w[t:] in blocks of 8, each in LANE_PERM order."""
    i = np.arange(0, t, 8)
    return w[t + i[:, None] + LANE_PERM].reshape(-1)


def expand_w_r4r2(w_tab: np.ndarray, q: int) -> np.ndarray:
    """The r4r2 table, 5N entries (``ntt_tpu.twiddles.expand_w_r4r2``):
    flat quintuple runs while the head index is below N/16, then from the
    next multiple of 8 the radix-2 tail: for even log2 N the N/16 entries
    of the t = 8 stage as they are, the t = 4 stage's entries each 4 times,
    the t = 2 stage's in the FwdT2 order, the t = 1 stage's in the FwdT1
    order."""
    w = np.asarray(w_tab, dtype=np.uint64)
    n = w.shape[0]
    out = np.zeros(5 * n, dtype=np.uint64)
    t = n >> 4
    new_idx, w_idx, _ = _quintuple_runs(w, out, q, 1, 1, 1, t)
    new_idx = ((new_idx >> 3) << 3) + 8
    if (n.bit_length() - 1) % 2 == 0:
        out[new_idx : new_idx + t] = w[w_idx : w_idx + t]
        new_idx += t
    t <<= 1
    out[new_idx : new_idx + 4 * t] = np.repeat(w[t : 2 * t], 4)
    new_idx += 4 * t
    t <<= 1
    seg = _t2_entries(w, t)
    out[new_idx : new_idx + seg.size] = seg
    new_idx += seg.size
    t <<= 1
    seg = _t1_entries(w, t)
    out[new_idx : new_idx + seg.size] = seg
    return out


def expand_w_r2_16(w_tab: np.ndarray) -> np.ndarray:
    """The r2_16 table, 3N entries (``ntt_tpu.twiddles.expand_w_r2_16``):
    [0, N/8) as it is, then the t = 4 stage's entries each 4 times, the
    t = 2 stage's in the FwdT2 order and the t = 1 stage's in the FwdT1
    order."""
    w = np.asarray(w_tab, dtype=np.uint64)
    n = w.shape[0]
    out = np.zeros(3 * n, dtype=np.uint64)
    t = n >> 3
    out[:t] = w[:t]
    new_idx = t
    out[new_idx : new_idx + 4 * t] = np.repeat(w[t : 2 * t], 4)
    new_idx += 4 * t
    t <<= 1
    seg = _t2_entries(w, t)
    out[new_idx : new_idx + seg.size] = seg
    new_idx += seg.size
    t <<= 1
    seg = _t1_entries(w, t)
    out[new_idx : new_idx + seg.size] = seg
    return out


# ---------------------------------------------------------------------------
# The tables of the 'mxu' variant (``ntt_tpu/kernels/mxu.py:62-104`` and
# :194-239): its two matrices split into int8 limbs of 7 bits, and the
# (N1, N2) twiddle (forward) or scale (inverse, n^-1 folded in) with its
# word-32 Shoup constant, each row a ``_power_rows`` run instead of the JAX
# builders' Python loops over entries.
# ---------------------------------------------------------------------------

MXU_LIMB_BITS = 7
MXU_LIMBS = 4  # 4 x 7 = 28 bits
MXU_MAX_Q_BITS = MXU_LIMB_BITS * MXU_LIMBS


def mxu_split(n: int) -> int:
    """log2 N1 of the mxu variant: the balanced split, N1 = 2^(m // 2)
    (``ntt_tpu.kernels.mxu.get_mxu_tables``), so N2 >= N1."""
    return (n.bit_length() - 1) // 2


def limbs_of_matrix(mat: np.ndarray) -> np.ndarray:
    """(MXU_LIMBS, *mat.shape) int8: the 7-bit limbs of uint64 entries."""
    v = np.ascontiguousarray(mat, dtype=np.uint64)
    mask = np.uint64((1 << MXU_LIMB_BITS) - 1)
    return np.stack([((v >> np.uint64(MXU_LIMB_BITS * s)) & mask).astype(np.int8)
                     for s in range(MXU_LIMBS)])


def mxu_tables(psi: int, q: int, n: int, inverse: bool = False) -> dict:
    """The mxu tables of N = N1 * N2 at the balanced split (``mxu_split``)
    under the 2N-th root psi, with the JAX package's keys.  Forward (``build_mxu_tables``): ``m1`` the limbs of
    M1[j1, k1] = phi^((2 br(j1) + 1) k1), phi = psi^N2; ``w2`` those of
    W2[j2, k2] = xi^(br(j2) k2), xi = psi^(2 N1); ``t`` = T[i1, k2] =
    psi^((2 br(i1) + 1) k2) and ``t_con`` its word-32 Shoup constants.
    Inverse (``build_mxu_inv_tables``), under psi^-1: ``w2i`` the limbs of
    W2i[k2, j2] = xi^(-br(j2) k2), ``m1i`` those of M1i[k1, j1] =
    phi^(-(2 br(j1) + 1) k1), ``s`` = S[i1, k2] = N^-1 psi^(-(2 br(i1) + 1) k2)
    and ``s_con``.  Limbs are int8 numpy, the rest uint64 numpy; q < 2^28."""
    if q >= 1 << MXU_MAX_Q_BITS:
        raise ValueError(f"the mxu tables need q < 2^{MXU_MAX_Q_BITS}, got a "
                         f"{q.bit_length()}-bit q")
    n1_log = mxu_split(n)
    logn = n.bit_length() - 1
    n1, n2 = 1 << n1_log, 1 << (logn - n1_log)
    root = pow(psi, -1, q) if inverse else psi
    phi, xi = pow(root, n2, q), pow(root, 2 * n1, q)
    odd1 = 2 * bit_rev_perm(n1) + 1
    br2 = bit_rev_perm(n2)

    def bases(b: int, exps: np.ndarray) -> np.ndarray:
        return np.array([pow(b, int(e), q) for e in exps], dtype=np.uint64)

    mat1 = _power_rows(bases(phi, odd1), n1, q)  # [j1, k1]
    mat2 = _power_rows(bases(xi, br2), n2, q)  # [j2, k2]
    tab = _power_rows(bases(root, odd1), n2, q)  # [i1, k2]
    if not inverse:
        return {"m1": limbs_of_matrix(mat1), "w2": limbs_of_matrix(mat2), "t": tab,
                "t_con": calc_w_con(tab, q, 32), "n1_log": n1_log}
    tab = mul_mod(tab, np.full_like(tab, pow(n, -1, q)), q)
    return {"w2i": limbs_of_matrix(mat2.T), "m1i": limbs_of_matrix(mat1.T), "s": tab,
            "s_con": calc_w_con(tab, q, 32), "n1_log": n1_log}
