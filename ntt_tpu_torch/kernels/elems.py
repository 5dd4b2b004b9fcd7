"""Element ops: one butterfly API over the word-32 and word-64 reps.

The counterpart of ``ntt_tpu/kernels/elems.py``.  A rep is a single
tensor (int32 for q < 2^30, int64 for q < 2^62); the JAX package's
(lo, hi) uint32 limb pair does not exist here.  Twiddle operands are
tensors that broadcast against x and y; scalar constants are Python ints.
Each class also carries the primitives of the radix-4 butterflies
(``cond_sub``, ``const``, ``shoup_mul``, ``dbl``); ``W56Ops`` has only
those, at Shoup word 56 on int64 reps.
"""

from __future__ import annotations

from ntt_tpu_torch import modmath as mm


class U32Ops:
    """Word-32 Shoup constants; q < 2^30; int32 reps."""

    word = 32
    cond_sub = staticmethod(mm.cond_sub32)
    const = staticmethod(mm.s32)
    dbl = staticmethod(mm.shoup_dbl_mul32_q2)

    @staticmethod
    def fwd_bfly(x, y, wo, wc, q: int):
        """Harvey forward: inputs < 4q, outputs < 4q."""
        x1 = mm.cond_sub32(x, 2 * q)
        t = mm.shoup_mul32_q2(wo, wc, y, q)
        q2 = mm.s32(2 * q)
        return x1 + t, x1 + q2 - t

    @staticmethod
    def bkw_bfly(x, y, wo, wc, q: int):
        q2 = mm.s32(2 * q)
        x1 = mm.cond_sub32(x + y, 2 * q)
        t = x + q2 - y
        return x1, mm.shoup_mul32_q2(wo, wc, t, q)

    @staticmethod
    def bkw_final(x, y, n_inv_op: int, n_inv_con: int, tmp: int, con: int, q: int):
        """Final inverse stage with n^-1 fused; ``con`` may be 33 bits wide,
        its top bit adds t to the quotient."""
        x1 = x + y
        t = x + mm.s32(2 * q) - y
        nx = mm.cond_sub32(mm.shoup_mul32_q2(n_inv_op, n_inv_con, x1, q), q)
        big_q = mm.mulhi32(con & mm.MASK32, t)
        if con >> 32:
            big_q = big_q + t
        ny = mm.cond_sub32(mm.s32(tmp) * t - big_q * mm.s32(q), q)
        return nx, ny

    @staticmethod
    def reduce_4q_to_q(x, q: int):
        return mm.reduce32(x, q, 4)

    @staticmethod
    def shoup_mul(w, wc, x, q: int):
        """Constant w (Shoup constant wc) times x < 4q; output < 2q."""
        return mm.shoup_mul32_q2(w, wc, x, q)

    @staticmethod
    def mul_mod(x, y, q: int):
        return mm.mul_mod_q32(x, y, q)


class U64Ops:
    """Word-64 Shoup constants; any q < 2^62; int64 reps.  Bit-exact with
    ``ntt_tpu.refmodel`` including lazy representatives."""

    word = 64
    cond_sub = staticmethod(mm.cond_sub64)
    const = staticmethod(mm.s64)
    dbl = staticmethod(mm.shoup_dbl_mul_q2)

    @staticmethod
    def fwd_bfly(x, y, wo, wc, q: int):
        x1 = mm.reduce_4q_to_2q(x, q)
        t = mm.shoup_mul_q2(wo, wc, y, q)
        return x1 + t, x1 + mm.s64(2 * q) - t

    @staticmethod
    def bkw_bfly(x, y, wo, wc, q: int):
        x1 = mm.reduce_4q_to_2q(x + y, q)
        t = x + mm.s64(2 * q) - y
        return x1, mm.shoup_mul_q2(wo, wc, t, q)

    @staticmethod
    def bkw_final(x, y, n_inv_op: int, n_inv_con: int, tmp: int, con: int, q: int):
        """As U32Ops.bkw_final at word 64; ``con`` may be 65 bits wide."""
        x1 = x + y
        t = x + mm.s64(2 * q) - y
        nx = mm.shoup_mul_q(n_inv_op, n_inv_con, x1, q)
        big_q = mm.mulhi64(con & ((1 << 64) - 1), t)
        if con >> 64:
            big_q = big_q + t
        ny = mm.reduce_2q_to_q(mm.s64(tmp) * t - big_q * mm.s64(q), q)
        return nx, ny

    @staticmethod
    def reduce_4q_to_q(x, q: int):
        return mm.reduce_4q_to_q(x, q)

    @staticmethod
    def shoup_mul(w, wc, x, q: int):
        return mm.shoup_mul_q2(w, wc, x, q)

    @staticmethod
    def mul_mod(x, y, q: int):
        return mm.mul_mod_q(x, y, q)


class W56Ops:
    """Shoup constants at word 56 (the JAX package's 'radix4-w56', the
    s390x VMSL form); q < 2^52; int64 reps."""

    word = 56
    cond_sub = staticmethod(mm.cond_sub64)
    const = staticmethod(mm.s64)
    shoup_mul = staticmethod(mm.shoup_mul56_q2)
    dbl = staticmethod(mm.shoup_dbl_mul56_q2)


def ops_at(word: int):
    """The ops of Shoup word 32, 56 or 64."""
    return {32: U32Ops, 56: W56Ops, 64: U64Ops}[word]


def pick_ops(q: int):
    return U32Ops if mm.uses_u32(q) else U64Ops
