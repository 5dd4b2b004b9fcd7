"""Six-step negacyclic NTT in plain PyTorch: the plain version of the fused
CUDA kernels in ``csrc/ntt_fused.cu``.

The counterpart of ``ntt_tpu/kernels/sixstep.py`` (``fwd_sixstep`` /
``inv_sixstep`` and their four phases).  With N = N1*N2 and the
coefficients viewed (N1, N2), the first log2 N1 Harvey stages are column
NTTs that read the global table's prefix w[1:N1]; every later stage s'
reads the slice w[2^s'*N1 : 2^(s'+1)*N1] viewed (N1, 2^s') and transposed
as per-row twiddles.  Every coefficient therefore meets the same
butterflies with the same twiddles as in the flat radix-2 transform
(``ntt_tpu.refmodel.fwd_ntt_harvey_lazy``), so any split gives the same
bits, lazy representatives included.

One stage per pass: the JAX package's grouping of stages and its
pre-broadcast twiddle stacks are XLA codegen levers and change no bit.
"""

from __future__ import annotations

import torch


def default_split(n: int) -> int:
    """log2 N1 for N = 2^logn: balanced, N1 >= 2 (the inverse's fused final
    stage halves the N1 axis)."""
    logn = n.bit_length() - 1
    return max(1, logn // 2)


def _stage(a, m: int, t: int, lanes: int, bfly, post=None):
    """One butterfly stage along the second-to-last axis of (..., M, L)."""
    lead = a.shape[:-2]
    v = a.reshape(lead + (m, 2, t, lanes))
    nx, ny = bfly(v[..., 0, :, :], v[..., 1, :, :])
    if post is not None:
        nx, ny = post(nx), post(ny)
    return torch.stack([nx, ny], dim=-3).reshape(lead + (2 * m * t, lanes))


def _col_tw(w, m: int):
    """Column twiddles of the stage with m groups: w[m:2m]."""
    return w[m : 2 * m].reshape(m, 1, 1)


def _row_tw(w, m2: int, n1: int):
    """Row twiddles of row stage s' (m2 = 2^s' groups per row): the slice
    w[m2*N1 : 2*m2*N1] viewed (N1, m2), transposed to (m2, 1, N1)."""
    return w[m2 * n1 : 2 * m2 * n1].reshape(n1, m2).T.reshape(m2, 1, n1)


def fwd_phase1(a, ops, w, wc, q: int, n1: int, lanes: int):
    """Forward column stages on (..., N1, L): every stage with m < N1."""
    for s in range(n1.bit_length() - 1):
        m, t = 1 << s, n1 >> (s + 1)
        wo, wco = _col_tw(w, m), _col_tw(wc, m)
        a = _stage(a, m, t, lanes, lambda x, y: ops.fwd_bfly(x, y, wo, wco, q))
    return a


def fwd_phase2(a, ops, w, wc, q: int, n1: int, n2: int, strict: bool = False):
    """Forward row stages on the transposed view (..., N2, N1); with strict
    the 4q -> q reduction is applied to the last stage's outputs."""
    logn2 = n2.bit_length() - 1
    if logn2 == 0:
        return ops.reduce_4q_to_q(a, q) if strict else a
    for s in range(logn2):
        m2, t = 1 << s, n2 >> (s + 1)
        wo, wco = _row_tw(w, m2, n1), _row_tw(wc, m2, n1)
        post = None
        if strict and s == logn2 - 1:
            post = lambda v: ops.reduce_4q_to_q(v, q)  # noqa: E731
        a = _stage(a, m2, t, n1, lambda x, y: ops.fwd_bfly(x, y, wo, wco, q),
                   post=post)
    return a


def inv_phaseA(a, ops, w, wc, q: int, n1: int, n2: int):
    """Inverse row stages (global m = N/2 .. N1) on (..., N2, N1)."""
    for s in reversed(range(n2.bit_length() - 1)):
        m2, t = 1 << s, n2 >> (s + 1)
        wo, wco = _row_tw(w, m2, n1), _row_tw(wc, m2, n1)
        a = _stage(a, m2, t, n1, lambda x, y: ops.bkw_bfly(x, y, wo, wco, q))
    return a


def inv_phaseB(a, ops, w, wc, n_inv_op: int, n_inv_con: int, final_tmp: int,
               final_con: int, q: int, n1: int, lanes: int):
    """Inverse column stages (global m = N1/2 .. 2) and the fused final
    n^-1 stage, on (..., N1, L)."""
    for s in reversed(range(1, n1.bit_length() - 1)):
        m, t = 1 << s, n1 >> (s + 1)
        wo, wco = _col_tw(w, m), _col_tw(wc, m)
        a = _stage(a, m, t, lanes, lambda x, y: ops.bkw_bfly(x, y, wo, wco, q))
    half = n1 // 2
    nx, ny = ops.bkw_final(a[..., :half, :], a[..., half:, :], n_inv_op,
                           n_inv_con, final_tmp, final_con, q)
    return torch.cat([nx, ny], dim=-2)


def _split(n: int, n1_log: int | None):
    logn = n.bit_length() - 1
    if n1_log is None:
        n1_log = default_split(n)
    if not 1 <= n1_log <= logn:
        raise ValueError(f"n1_log={n1_log} outside [1, {logn}] for N={n}")
    return 1 << n1_log, 1 << (logn - n1_log)


def fwd_sixstep(a, ops, w, wc, q: int, n1_log: int | None = None,
                strict: bool = True):
    """Forward NTT of a (..., N) rep: natural order in, bit-reversed out;
    output < q with strict, else < 4q."""
    n = a.shape[-1]
    n1, n2 = _split(n, n1_log)
    lead = a.shape[:-1]
    a = fwd_phase1(a.reshape(lead + (n1, n2)), ops, w, wc, q, n1, n2)
    a = fwd_phase2(a.transpose(-1, -2), ops, w, wc, q, n1, n2, strict=strict)
    return a.transpose(-1, -2).reshape(lead + (n,))


def inv_sixstep(a, ops, w, wc, n_inv_op: int, n_inv_con: int, final_tmp: int,
                final_con: int, q: int, n1_log: int | None = None):
    """Inverse NTT of a (..., N) rep (strict output).  w/wc are the inverse
    root tables; final_tmp/final_con come from ``plan.final_mulop``."""
    n = a.shape[-1]
    n1, n2 = _split(n, n1_log)
    lead = a.shape[:-1]
    a = a.reshape(lead + (n1, n2)).transpose(-1, -2)
    a = inv_phaseA(a, ops, w, wc, q, n1, n2)
    a = inv_phaseB(a.transpose(-1, -2), ops, w, wc, n_inv_op, n_inv_con,
                   final_tmp, final_con, q, n1, n2)
    return a.reshape(lead + (n,))
