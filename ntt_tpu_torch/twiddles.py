"""Twiddle tables of one (q, m) instance, host-side, exact.

The port's own copy of the tables it reads from ``ntt_tpu/twiddles.py``:
the bit-reversed powers of the root and of its inverse, their Shoup
constants at a given word size, and the Shoup constant of n^-1.  The
values are those of the JAX package's builders; the bit reversal is
vectorised and the powers are built in one pass, so the tables of
N = 2^24 take seconds, not minutes.  Every table is numpy uint64.
"""

from __future__ import annotations

import numpy as np


def bit_rev_perm(n: int) -> np.ndarray:
    """Permutation p with p[i] = bitrev(i) over log2(n) bits (int64)."""
    width = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    p = np.zeros(n, dtype=np.int64)
    for b in range(width):
        p |= ((i >> b) & 1) << (width - 1 - b)
    return p


def calc_w(w: int, n: int, q: int) -> np.ndarray:
    """Bit-reversed table of w^i mod q, i in [0, N): out[bitrev(i)] = w^i."""
    powers = [1] * n
    cur = 1
    for i in range(1, n):
        cur = cur * w % q
        powers[i] = cur
    out = np.zeros(n, dtype=np.uint64)
    out[bit_rev_perm(n)] = np.array(powers, dtype=np.uint64)
    return out


def calc_w_inv(w_inv: int, n: int, q: int) -> np.ndarray:
    """The same table for the inverse root."""
    return calc_w(w_inv, n, q)


def calc_w_con(w_tab: np.ndarray, q: int, word_size: int = 64) -> np.ndarray:
    """Shoup constants floor(w_i * 2^word_size / q) of a table (word_size
    64, or 32 for the word-32 path, where they fit 32 bits for q < 2^30)."""
    vals = [(x << word_size) // q for x in np.asarray(w_tab, dtype=np.uint64).ravel().tolist()]
    return np.array(vals, dtype=np.uint64).reshape(np.shape(w_tab))


def calc_ninv_con(n_inv: int, q: int, word_size: int = 64) -> int:
    """The Shoup constant of n^-1."""
    return (n_inv << word_size) // q
