"""Six-step negacyclic NTT in plain PyTorch: the plain version of the CUDA
kernels in ``csrc/ntt_fused.cu`` (K1, K2) and ``csrc/ntt_sixstep.cu``
(K4 to K7).

The counterpart of ``ntt_tpu/kernels/sixstep.py`` (``fwd_sixstep`` /
``inv_sixstep``, their four phases, ``default_split``,
``fix_transposed_order``, and the two-level six-step's ``rec_split`` and
``_twist_mul``, the plain version of K8 in ``csrc/twist.cu``).  With N = N1*N2 and the coefficients viewed
(N1, N2), the first log2 N1 Harvey stages are column NTTs that read the
global table's prefix w[1:N1]; every later stage s' reads the slice
w[2^s'*N1 : 2^(s'+1)*N1] viewed (N1, 2^s') and transposed as per-row
twiddles.  Every coefficient therefore meets the same butterflies with the
same twiddles as in the flat radix-2 transform
(``ntt_tpu.refmodel.fwd_ntt_harvey_lazy``), so any split gives the same
bits, lazy representatives included.

The two-pass form splits each transform into two passes over device
memory, each on (..., N) tensors:

  * ``fwd_cols`` (K4): the column stages, (N1, N2) layout in and out;
  * ``fwd_rows`` (K5): the row stages with the optional strict reduce,
    (N1, N2) in, (N1, N2) out or, with keep_transposed, (N2, N1);
  * ``inv_rows`` (K6, the Pallas ``_inv_rows_kernel``): the reversed row
    stages, (N1, N2) in or, with input_transposed, (N2, N1); (N1, N2) out;
  * ``inv_cols`` (K7, the Pallas ``_inv_cols_kernel``): the reversed
    column stages and the fused n^-1 stage, (N1, N2) in and out.

The Pallas ``_inv_rows_kernel`` writes (N2, N1) for ``_inv_cols_kernel``
to read; here the layout between the two inverse passes is (N1, N2), so
that both column passes read and write the same layout.

One stage per pass: the JAX package's grouping of stages and its
pre-broadcast twiddle stacks are XLA codegen levers and change no bit.
"""

from __future__ import annotations

import torch


def default_split(n: int, min_lanes: int = 128, nlimb: int = 1) -> int:
    """log2 N1 of the JAX package's six-step (``ntt_tpu.kernels.sixstep.
    default_split``): N2 = 64 for N in [2^12, 2^17], N2 = 256 at N = 2^16
    for its two-limb (word-64) rep, else balanced with N2 >= min_lanes.
    It fixes the 'sixstep-unordered' layout, so the port keeps it as is;
    nlimb is 1 at word 32 and 2 at word 64."""
    logn = n.bit_length() - 1
    if logn == 16 and nlimb == 2:
        return 8
    if 12 <= logn <= 17:
        return logn - 6
    n1 = logn // 2
    while n1 > 1 and (1 << (logn - n1)) < min_lanes:
        n1 -= 1
    return max(1, min(n1, logn - 1))


def word_split(n: int, word: int) -> int:
    """default_split at a width: the two-pass form's split throughout."""
    return default_split(n, nlimb=word // 32)


def balanced_split(n: int) -> int:
    """log2 N1 for N = 2^logn: balanced, N1 >= 2 (the inverse's fused final
    stage halves the N1 axis).  The plain version of K1 / K2 uses it."""
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


def _row_tw(w, m2: int, n1: int, col0: int = 0, ncols: int | None = None):
    """Row twiddles of row stage s' (m2 = 2^s' groups per row): the slice
    w[m2*N1 : 2*m2*N1] viewed (N1, m2), transposed to (m2, 1, ncols) for
    the ncols rows from row col0 (all N1 by default; JAX's ``_row_tw``
    takes the same col0 / ncols, its columns being the rows here)."""
    ncols = n1 if ncols is None else ncols
    tw = w[m2 * n1 : 2 * m2 * n1].reshape(n1, m2)[col0 : col0 + ncols]
    return tw.T.reshape(m2, 1, ncols)


def fwd_phase1(a, ops, w, wc, q: int, n1: int, lanes: int):
    """Forward column stages on (..., N1, L): every stage with m < N1."""
    for s in range(n1.bit_length() - 1):
        m, t = 1 << s, n1 >> (s + 1)
        wo, wco = _col_tw(w, m), _col_tw(wc, m)
        a = _stage(a, m, t, lanes, lambda x, y: ops.fwd_bfly(x, y, wo, wco, q))
    return a


def fwd_phase2(a, ops, w, wc, q: int, n1: int, n2: int, col0: int = 0,
               ncols: int | None = None, strict: bool = False):
    """Forward row stages on the transposed view (..., N2, ncols) of the
    ncols rows from row col0 (all N1 by default: JAX's ``fwd_phase2`` with
    col0 / ncols); with strict the 4q -> q reduction is applied to the last
    stage's outputs."""
    ncols = n1 if ncols is None else ncols
    logn2 = n2.bit_length() - 1
    if logn2 == 0:
        return ops.reduce_4q_to_q(a, q) if strict else a
    for s in range(logn2):
        m2, t = 1 << s, n2 >> (s + 1)
        wo, wco = _row_tw(w, m2, n1, col0, ncols), _row_tw(wc, m2, n1, col0, ncols)
        post = None
        if strict and s == logn2 - 1:
            post = lambda v: ops.reduce_4q_to_q(v, q)  # noqa: E731
        a = _stage(a, m2, t, ncols, lambda x, y: ops.fwd_bfly(x, y, wo, wco, q),
                   post=post)
    return a


def inv_phaseA(a, ops, w, wc, q: int, n1: int, n2: int, col0: int = 0,
               ncols: int | None = None):
    """Inverse row stages (global m = N/2 .. N1) on (..., N2, ncols), the
    ncols rows from row col0 (all N1 by default)."""
    ncols = n1 if ncols is None else ncols
    for s in reversed(range(n2.bit_length() - 1)):
        m2, t = 1 << s, n2 >> (s + 1)
        wo, wco = _row_tw(w, m2, n1, col0, ncols), _row_tw(wc, m2, n1, col0, ncols)
        a = _stage(a, m2, t, ncols, lambda x, y: ops.bkw_bfly(x, y, wo, wco, q))
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


def _split(n: int, n1_log: int):
    logn = n.bit_length() - 1
    if not 1 <= n1_log <= logn:
        raise ValueError(f"n1_log={n1_log} outside [1, {logn}] for N={n}")
    return 1 << n1_log, 1 << (logn - n1_log)


def _row_shard(n: int, n1_log: int, row0: int, rows_log: int | None):
    """(N1, N2, rows) of a row pass's input of last dim n: rows [row0, row0 +
    2^rows_log) of the N1 = 2^n1_log rows of N2 words each (a whole
    polynomial with rows_log None: rows = N1)."""
    if rows_log is None:
        if row0:
            raise ValueError(f"row0={row0} needs rows_log")
        n1, n2 = _split(n, n1_log)
        return n1, n2, n1
    if not (n1_log >= 1 and 0 <= rows_log <= n1_log
            and 0 <= row0 <= (1 << n1_log) - (1 << rows_log)):
        raise ValueError(f"rows [{row0}, {row0} + 2^{rows_log}) outside the 2^{n1_log} rows")
    if n & (n - 1) or n < 1 << rows_log:
        raise ValueError(f"last dim {n} is no power of two of at least 2^{rows_log}")
    return 1 << n1_log, n >> rows_log, 1 << rows_log


def fwd_cols(a, ops, w, wc, q: int, n1_log: int):
    """Forward column stages of a (..., N) rep in the (N1, N2) layout; lazy
    output (< 4q), same layout.  N2 is the last dim over N1: a shard of
    N2 / D lanes of each row (the distributed six-step's) is (..., N1 * N2
    / D), and the column twiddles are the same for every lane."""
    n1, n2 = _split(a.shape[-1], n1_log)
    lead = a.shape[:-1]
    out = fwd_phase1(a.reshape(lead + (n1, n2)), ops, w, wc, q, n1, n2)
    return out.reshape(a.shape)


def fwd_rows(a, ops, w, wc, q: int, n1_log: int, strict: bool = True,
             keep_transposed: bool = False, row0: int = 0, rows_log: int | None = None):
    """Forward row stages of fwd_cols' output: (N1, N2) layout in; out in
    the (N1, N2) layout, or (N2, N1) with keep_transposed; < q with strict,
    else < 4q.  With rows_log, a shard: rows [row0, row0 + 2^rows_log) of
    the N1 = 2^n1_log rows, (rows, N2) in, (rows, N2) or (N2, rows) out."""
    n1, n2, rows = _row_shard(a.shape[-1], n1_log, row0, rows_log)
    lead = a.shape[:-1]
    t = a.reshape(lead + (rows, n2)).transpose(-1, -2)
    t = fwd_phase2(t, ops, w, wc, q, n1, n2, row0, rows, strict=strict)
    if not keep_transposed:
        t = t.transpose(-1, -2)
    return t.contiguous().reshape(a.shape)


def inv_rows(a, ops, w, wc, q: int, n1_log: int, input_transposed: bool = False,
             row0: int = 0, rows_log: int | None = None):
    """Inverse row stages (global m = N/2 .. N1) of a (..., N) rep in the
    (N1, N2) layout, or (N2, N1) with input_transposed; (N1, N2) out.  With
    rows_log, a shard of rows [row0, row0 + 2^rows_log), as fwd_rows."""
    n1, n2, rows = _row_shard(a.shape[-1], n1_log, row0, rows_log)
    lead = a.shape[:-1]
    if input_transposed:
        t = a.reshape(lead + (n2, rows))
    else:
        t = a.reshape(lead + (rows, n2)).transpose(-1, -2)
    t = inv_phaseA(t, ops, w, wc, q, n1, n2, row0, rows)
    return t.transpose(-1, -2).contiguous().reshape(a.shape)


def inv_cols(a, ops, w, wc, n_inv_op: int, n_inv_con: int, final_tmp: int,
             final_con: int, q: int, n1_log: int):
    """Inverse column stages (global m = N1/2 .. 2) and the fused final n^-1
    stage of inv_rows' output, (N1, N2) layout; strict output in the
    standard order.  N2 is the last dim over N1, as in fwd_cols: a shard of
    lanes takes the whole transform's n^-1 constants."""
    n1, n2 = _split(a.shape[-1], n1_log)
    lead = a.shape[:-1]
    out = inv_phaseB(a.reshape(lead + (n1, n2)), ops, w, wc, n_inv_op, n_inv_con,
                     final_tmp, final_con, q, n1, n2)
    return out.reshape(a.shape)


def fwd_sixstep(a, ops, w, wc, q: int, n1_log: int | None = None,
                strict: bool = True, keep_transposed: bool = False):
    """Forward NTT of a (..., N) rep: natural order in, bit-reversed out
    (or, with keep_transposed, the (N2, N1) layout that
    fix_transposed_order undoes); output < q with strict, else < 4q.  The
    split defaults to the JAX package's at the ops' width."""
    if n1_log is None:
        n1_log = word_split(a.shape[-1], ops.word)
    a = fwd_cols(a, ops, w, wc, q, n1_log)
    return fwd_rows(a, ops, w, wc, q, n1_log, strict, keep_transposed)


def inv_sixstep(a, ops, w, wc, n_inv_op: int, n_inv_con: int, final_tmp: int,
                final_con: int, q: int, n1_log: int | None = None,
                input_transposed: bool = False):
    """Inverse NTT of a (..., N) rep (strict output).  w/wc are the inverse
    root tables; final_tmp/final_con come from ``plan.final_mulop``.  With
    input_transposed the input is in fwd_sixstep's keep_transposed layout."""
    if n1_log is None:
        n1_log = word_split(a.shape[-1], ops.word)
    a = inv_rows(a, ops, w, wc, q, n1_log, input_transposed)
    return inv_cols(a, ops, w, wc, n_inv_op, n_inv_con, final_tmp, final_con, q,
                    n1_log)


def rec_split(logn: int) -> int:
    """log2 N1 of the two-level six-step: balanced, logn // 2."""
    return logn // 2


def twist_mul(a, ops, tw, q: int):
    """The two-level six-step's twist (JAX ``sixstep._twist_mul``): a (..., N)
    rep in the (N1, N2) layout times T[c, h LO + l] = A[c, h] B[c, l], as two
    chained Shoup products, first by A, then by B; tw = (A, Ac, B, Bc) of
    shapes (N1, HI) and (N1, LO), or a shard of rows: the tables' rows of
    the shard, N1 its row count.  Inputs < 4q, output < 2q."""
    tw_a, tw_ac, tw_b, tw_bc = tw
    (n1, hi), lo = tw_a.shape, tw_b.shape[-1]
    v = a.reshape(a.shape[:-1] + (n1, hi, lo))
    v = ops.shoup_mul(tw_a[:, :, None], tw_ac[:, :, None], v, q)
    v = ops.shoup_mul(tw_b[:, None, :], tw_bc[:, None, :], v, q)
    return v.reshape(a.shape)


def fix_transposed_order(a, n1_log: int):
    """Undo the keep_transposed layout: (..., N) flattened (N2, N1) ->
    flattened (N1, N2)."""
    n = a.shape[-1]
    logn = n.bit_length() - 1
    n1, n2 = 1 << n1_log, 1 << (logn - n1_log)
    lead = a.shape[:-1]
    return a.reshape(lead + (n2, n1)).transpose(-1, -2).reshape(lead + (n,))
