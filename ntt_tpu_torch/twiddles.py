"""Twiddle tables of one (q, m) instance, host-side, exact.

The port's own copy of the tables it reads from ``ntt_tpu/twiddles.py``:
the bit-reversed powers of the root and of its inverse, their Shoup
constants at a given word size, the Shoup constant of n^-1, and the
factored twist tables of the two-level six-step.  The
values are those of the JAX package's builders, computed exactly in
vectorised uint64 arithmetic (the powers as a (sqrt N x sqrt N) grid of
Shoup products, the Shoup constants in two 32-bit quotient digits), so a
table of N = 2^24 takes seconds, not the minute of a Python loop.  Every
table is numpy uint64.
"""

from __future__ import annotations

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


def _quotient_digit(z: np.ndarray, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(floor(z * 2^32 / q), z * 2^32 mod q) for uint64 z < q < 2^62: a
    float64 estimate, off by at most one, corrected by the exact remainder,
    which lies in [-q, 2q) and so fits int64 (wrapping uint64 products)."""
    qu = np.uint64(q)
    d = np.floor(z.astype(np.float64) * 2.0**32 / float(q)).astype(np.uint64)
    r = ((z << _U32) - d * qu).view(np.int64)
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


def calc_w_con(w_tab: np.ndarray, q: int, word_size: int = 64) -> np.ndarray:
    """Shoup constants floor(w_i * 2^word_size / q) of a table (word_size
    64, or 32 for the word-32 path, where they fit 32 bits for q < 2^30);
    entries below q < 2^62, the port's limit (the lazy butterflies keep
    values below 4q < 2^64)."""
    if q >= Q_LIMIT:
        raise ValueError(f"q = {q:#x} is not below 2^62")
    x = np.asarray(w_tab, dtype=np.uint64)
    hi, rem = _quotient_digit(x.ravel(), q)
    if word_size == 32:
        return hi.reshape(x.shape)
    lo, _ = _quotient_digit(rem, q)
    return ((hi << _U32) | lo).reshape(x.shape)


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
