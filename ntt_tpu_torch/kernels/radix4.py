"""Radix-4 transforms of the reference's families: CUDA kernel K10
``r4_stage``, its wrapper and plain version, and the transforms built of
its launches.

The counterpart of ``ntt_tpu/kernels/radix4.py``: the five-twiddle
butterflies (:57-93, word 32 :439-467), whose y-products are one dual
Shoup product each (one quotient of the 128-bit sum of two constant
products, ``modmath.shoup_dbl_mul_q2``); 'radix4' (word 64, :95-149 and
:174-238), 'radix4-w56' (Shoup word 56, :151-172) and 'radix4-u32' (word
32, :469-533), whose forward ends in a radix-2 sweep for odd log2 N and
whose inverse starts with one; and 'radix4-vec' / 'radix4-vec-unordered'
(:241-427), which read the 5N vector layout (``twiddles.expand_w_r4``)
region by region, start with a radix-2 stage for odd log2 N (and end
with one in the inverse), and in the unordered form take the groups of
the last radix-4 stage in LANE_PERM order, which the unordered inverse
reads as they are.

A radix-4 stage of N words has m groups of 4t words (x, y, z, t at
offsets 0, t, 2t, 3t of the group, t = N / 4m); group g reads its five
twiddles from the 2N ``expand_w`` table at ``_quint_indices`` (TW_EXPAND)
or from a region of a 5N layout at ``base + (g >> L) * 5 * 2^L +
k * 2^L + (g & (2^L - 1))`` (TW_REGION, blocks of 2^L groups).  A radix-2
stage of K10 pairs (i0, i0 + t) and reads its twiddle at ``base + g *
step``.  ``pre`` reduces all four inputs 8q -> 2q (the inverse's first
stage) or x alone 8q -> 4q (the radix-2 sweeps of 'radix4'); ``post``
reduces the outputs 8q -> q (a strict forward) or scales them by n^-1
with a strict result (the inverse's last stage).

K10 (``csrc/r4_stage.cu``) replaces the JAX package's jnp stages
(radix4.py:95, :151, :174, :294, :353, :469, :501; mixed.py:55, :151,
:215), fused a stage at a time by XLA on the TPU.  One launch a stage,
one thread a group of four words, over device memory: a radix-4 stage
reads and writes every word once for two butterfly layers, so it moves
half the bytes of two K9 stages; the dual products cost about as many
multiplies as three Shoup products.  Holding the transform on chip is
later work.

The wrapper runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; it never falls back from one to the other.
Each call is a kernel span (``trace.py``); ``native.launch`` counts each
launch in ``trace.LAUNCHES``, and the wrapper again under
``mode/<launcher>/<stage mode>/<twiddle layout>``.  Under the
NTT_MULMOD=solinas switch, at a q of the Solinas form of the stage's word
(32 or 64), the wrapper launches K10's Solinas instantiation (the single
products switched, the dual ones Shoup); word 56 never switches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native, trace
from ntt_tpu_torch import twiddles as tw
from ntt_tpu_torch.kernels.elems import ops_at
from ntt_tpu_torch.kernels.radix2 import Launch, check_cuda, run, with_stage
from ntt_tpu_torch.plan import NttPlan

R4_FWD, R4_INV, R2_FWD, R2_BKW = 0, 1, 2, 3  # stage modes
PRE_NONE, PRE_ALL_8Q_2Q, PRE_X_8Q_4Q = 0, 1, 2
POST_NONE, POST_8Q_Q, POST_NINV = 0, 1, 2
TW_EXPAND, TW_REGION = 0, 1
PERM_NONE, PERM_READ, PERM_WRITE = 0, 1, 2  # LANE_PERM on the groups of a t == 1 stage
MODE_NAMES = ("r4_fwd", "r4_inv", "r2_fwd", "r2_bkw")
TW_NAMES = ("expand", "region")  # a radix-2 sweep's: "pairs"

LANE_UNPERM = np.argsort(tw.LANE_PERM)


@dataclasses.dataclass(frozen=True)
class R4Stage:
    """One stage of K10 (see the module docstring); ``step`` is the
    region's L for a radix-4 stage and the twiddle step a group for a
    radix-2 one."""

    lt: int
    mode: int = R4_FWD
    pre: int = PRE_NONE
    post: int = POST_NONE
    tw: int = TW_EXPAND
    base: int = 0
    step: int = 0
    perm: int = PERM_NONE


def quint_index(st: R4Stage, m: int) -> np.ndarray:
    """(5, m) twiddle indices of a radix-4 stage's groups
    (``ntt_tpu.kernels.radix4._quint_indices`` for TW_EXPAND)."""
    g = np.arange(m)
    if st.tw == TW_EXPAND:
        m1 = 2 * (m + g)
        return np.stack([m1, 2 * m1, 2 * m1 + 1, 2 * m1 + 2, 2 * m1 + 3])
    lane = 1 << st.step
    k = np.arange(5)[:, None]
    return st.base + (g >> st.step) * 5 * lane + k * lane + (g & (lane - 1))


def _fwd_bfly(ops, x, y, z, t, w5, q: int):
    """``ntt_tpu.kernels.radix4._r4_fwd_bfly_u64`` (and ``_u32``):
    inputs < 8q, outputs < 8q."""
    (w0, c0), (w1, c1), (w2, c2), (w3, c3), (w4, c4) = w5
    y1 = ops.dbl(w1, c1, w2, c2, y, t, q)
    y2 = ops.dbl(w3, c3, w4, c4, y, t, q)
    t1 = ops.cond_sub(x, 4 * q)
    t2 = ops.shoup_mul(w0, c0, z, q)
    s, d = t1 + t2, t1 - t2
    q2, q4 = ops.const(2 * q), ops.const(4 * q)
    return s + y1, s + q2 - y1, d + q2 + y2, d + q4 - y2


def _inv_bfly(ops, x, y, z, t, w5, q: int):
    """``ntt_tpu.kernels.radix4._r4_inv_bfly_u64`` (and ``_u32``)."""
    (w0, c0), (w1, c1), (w2, c2), (w3, c3), (w4, c4) = w5
    q4 = ops.const(4 * q)
    t0, t1 = z + t, x + y
    t2, t3 = x + q4 - y, z + q4 - t
    nx = ops.cond_sub(ops.cond_sub(t1 + t0, 4 * q), 2 * q)
    nz = ops.cond_sub(ops.shoup_mul(w0, c0, t1 + q4 - t0, q), q)
    return (nx, ops.dbl(w1, c1, w3, c3, t2, t3, q), nz,
            ops.dbl(w2, c2, w4, c4, t2, t3, q))


def _groups8(v: torch.Tensor, order: np.ndarray) -> torch.Tensor:
    """(..., m, 4, 1) with each block of 8 groups re-ordered: position s
    takes group order[s]."""
    lead = v.shape[:-3]
    m = v.shape[-3]
    return v.reshape(lead + (m // 8, 8, 4, 1))[..., order, :, :].reshape(v.shape)


def plain_stage(a: torch.Tensor, tab: torch.Tensor, con: torch.Tensor, st: R4Stage, q: int,
                word: int, consts) -> torch.Tensor:
    """K10's plain version: one stage of (..., N), as the JAX stages."""
    ops = ops_at(word)
    n = a.shape[-1]
    t = 1 << st.lt
    lead = a.shape[:-1]
    if st.mode in (R2_FWD, R2_BKW):
        m = n // (2 * t)
        v = a.reshape(lead + (m, 2, t))
        x, y = v[..., 0, :], v[..., 1, :]
        if st.pre == PRE_X_8Q_4Q:
            x = ops.cond_sub(x, 4 * q)
        idx = torch.from_numpy(st.base + np.arange(m) * st.step).to(a.device)[:, None]
        w, wc = tab[idx], con[idx]
        if st.mode == R2_FWD:
            x1 = ops.cond_sub(x, 2 * q)
            tt = ops.shoup_mul(w, wc, y, q)
            outs = [x1 + tt, x1 + ops.const(2 * q) - tt]
        else:
            outs = [ops.cond_sub(x + y, 2 * q),
                    ops.shoup_mul(w, wc, x + ops.const(2 * q) - y, q)]
    else:
        m = n // (4 * t)
        v = a.reshape(lead + (m, 4, t))
        if st.perm == PERM_READ:
            v = _groups8(v, tw.LANE_PERM)
        xs = [v[..., k, :] for k in range(4)]
        if st.pre == PRE_ALL_8Q_2Q:
            xs = [ops.cond_sub(ops.cond_sub(x, 4 * q), 2 * q) for x in xs]
        idx = torch.from_numpy(quint_index(st, m)).to(a.device)[..., None]
        w5 = [(tab[idx[k]], con[idx[k]]) for k in range(5)]
        bfly = _fwd_bfly if st.mode == R4_FWD else _inv_bfly
        outs = list(bfly(ops, *xs, w5, q))
    if st.post == POST_8Q_Q:
        outs = [ops.cond_sub(ops.cond_sub(ops.cond_sub(o, 4 * q), 2 * q), q) for o in outs]
    elif st.post == POST_NINV:
        n_inv, n_inv_con = consts[:2]
        outs = [ops.cond_sub(ops.shoup_mul(n_inv, n_inv_con, o, q), q) for o in outs]
    out = torch.stack(outs, dim=-2)
    if st.perm == PERM_WRITE:
        out = _groups8(out, LANE_UNPERM)
    return out.reshape(a.shape)


@trace.traced("kernel")
def r4_stage(a: torch.Tensor, tab: torch.Tensor, con: torch.Tensor, st: R4Stage, q: int,
             word: int, consts) -> torch.Tensor:
    """K10: one stage of (..., N) at Shoup word 32 (int32 reps), 56 or 64
    (int64 reps), twiddles from ``tab`` / ``con`` (tensors of the input's
    dtype); consts = (n_inv, n_inv_con, ...) of POST_NINV at that word."""
    if native.route(a) == "cpu":
        return plain_stage(a, tab, con, st, q, word, consts)
    rows, logn = check_cuda(a, word)
    radix = 4 if st.mode in (R4_FWD, R4_INV) else 2
    if not 0 <= st.lt or (radix << st.lt) > 1 << logn:
        raise ValueError(f"stage lt={st.lt} does not fit radix-{radix} groups of N=2^{logn}")
    if st.perm != PERM_NONE and (st.lt != 0 or logn < 5 or radix != 4):
        raise ValueError("the group permutations take a radix-4 stage with t == 1, N >= 32")
    for t in (tab, con):
        if t.device != a.device or t.dtype != a.dtype or not t.is_contiguous():
            raise ValueError("the twiddle tables must be contiguous, of the input's "
                             "device and dtype")
    out = torch.empty_like(a)
    if rows == 0:
        return out
    sol = mm.solinas_args(q, word)  # never at word 56
    name = "r4_stage_w56" if word == 56 else native.entry("r4_stage", word, sol)
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), tab.data_ptr(), con.data_ptr(), q,
                      rows, logn, st.lt, st.mode, st.pre, st.post, st.tw, st.base, st.step,
                      st.perm, consts[0], consts[1], *(sol or ()), native.stream(a.device))
    view = TW_NAMES[st.tw] if radix == 4 else "pairs"
    trace.LAUNCHES[f"mode/{name}/{MODE_NAMES[st.mode]}/{view}"] += 1
    return out


def k10(st: R4Stage, tab: str) -> Launch:
    return Launch(r4_stage, plain_stage, st, tab)


def fwd_launches(n: int, strict: bool) -> list[Launch]:
    """'radix4' forward: radix-4 stages m = 1, 4, ... on the 2N table, and
    for odd log2 N a final radix-2 sweep over the pairs (2i, 2i + 1),
    x reduced 8q -> 4q first, twiddle w_r4[N + 2i]."""
    logn = n.bit_length() - 1
    bound = n if logn % 2 == 0 else n >> 1
    out, m = [], 1
    while m < bound:
        out.append(k10(R4Stage(lt=(n // (4 * m)).bit_length() - 1), "w_r4"))
        m <<= 2
    if logn % 2:
        out.append(k10(R4Stage(lt=0, mode=R2_FWD, pre=PRE_X_8Q_4Q, base=n, step=2), "w_r4"))
    return with_stage(out, -1, post=POST_8Q_Q) if strict else out


def inv_launches(n: int) -> list[Launch]:
    """'radix4' inverse: for odd log2 N a leading radix-2 sweep over the
    pairs (2i, 2i + 1) (x reduced 8q -> 4q first), for even log2 N all
    inputs reduced 8q -> 2q first; radix-4 stages m = N/4 (N/8), ..., 1 on
    the inverse 2N table; the last stage scaled by n^-1, strict."""
    logn = n.bit_length() - 1
    out = []
    m = n >> 2
    if logn % 2:
        out.append(k10(R4Stage(lt=0, mode=R2_BKW, pre=PRE_X_8Q_4Q, base=n, step=2),
                       "w_inv_r4"))
        m >>= 1
    while m > 0:
        out.append(k10(R4Stage(lt=(n // (4 * m)).bit_length() - 1, mode=R4_INV), "w_inv_r4"))
        m >>= 2
    if logn % 2 == 0:
        out = with_stage(out, 0, pre=PRE_ALL_8Q_2Q)
    return with_stage(out, -1, post=POST_NINV)


VEC_MIN_LOGN = 8


def _vec_table(inverse: bool, unordered: bool) -> str:
    return "w_r4_vec" + ("_inv" if inverse else "") + ("_unord" if unordered else "")


def vec_fwd_launches(n: int, strict: bool, unordered: bool) -> list[Launch]:
    """'radix4-vec(-unordered)' forward (word 64): for odd log2 N a leading
    radix-2 stage over (i, i + N/2) with twiddle entry 1, then the radix-4
    stages m = 1 (2), ..., N/4 from the FWD8 / FWD4 / FWD1 regions; the
    unordered form reads the FWD1 stage's groups in LANE_PERM order."""
    logn = n.bit_length() - 1
    if logn < VEC_MIN_LOGN:
        raise ValueError(f"radix4-vec needs N >= 256, got N=2^{logn}")
    tab = _vec_table(False, unordered)
    out = []
    if logn % 2:
        out.append(k10(R4Stage(lt=logn - 1, mode=R2_FWD, base=1), tab))
    for m, (lanes, base) in sorted(tw.r4_vec_regions(n).items()):
        perm = PERM_READ if unordered and lanes == 3 else PERM_NONE
        out.append(k10(R4Stage(lt=(n // (4 * m)).bit_length() - 1, tw=TW_REGION,
                               base=base, step=lanes, perm=perm), tab))
    return with_stage(out, -1, post=POST_8Q_Q) if strict else out


def vec_inv_launches(n: int, unordered: bool) -> list[Launch]:
    """The inverse over the inverse root's 5N table, regions in reverse
    (all inputs 8q -> 2q first; the unordered form reads the unordered
    layout and puts the FWD1 stage's groups back in order), then for odd
    log2 N a trailing radix-2 stage with twiddle entry 1; the last stage
    scaled by n^-1, strict."""
    logn = n.bit_length() - 1
    if logn < VEC_MIN_LOGN:
        raise ValueError(f"radix4-vec needs N >= 256, got N=2^{logn}")
    tab = _vec_table(True, unordered)
    out = []
    for m, (lanes, base) in sorted(tw.r4_vec_regions(n).items(), reverse=True):
        perm = PERM_WRITE if unordered and lanes == 3 else PERM_NONE
        out.append(k10(R4Stage(lt=(n // (4 * m)).bit_length() - 1, mode=R4_INV,
                               tw=TW_REGION, base=base, step=lanes, perm=perm), tab))
    if logn % 2:
        out.append(k10(R4Stage(lt=logn - 1, mode=R2_BKW, base=1), tab))
    return with_stage(with_stage(out, 0, pre=PRE_ALL_8Q_2Q), -1, post=POST_NINV)


def fwd(a: torch.Tensor, plan: NttPlan, word: int, strict: bool = True,
        plain: bool = False) -> torch.Tensor:
    """'radix4' (word 64), 'radix4-w56' (56), 'radix4-u32' (32) forward:
    strict, or lazy (< 8q for even log2 N, < 4q for odd)."""
    return run(a, plan, fwd_launches(plan.n, strict), word, plain)


def inv(a: torch.Tensor, plan: NttPlan, word: int, plain: bool = False) -> torch.Tensor:
    """Their inverse (strict), for inputs below 8q."""
    return run(a, plan, inv_launches(plan.n), word, plain)


def fwd_vec(a: torch.Tensor, plan: NttPlan, strict: bool = True, unordered: bool = False,
            plain: bool = False) -> torch.Tensor:
    """'radix4-vec' forward (lazy < 8q); with unordered the output in the
    ``layouts.radix4_vec_unordered`` order."""
    return run(a, plan, vec_fwd_launches(plan.n, strict, unordered), 64, plain)


def inv_vec(a: torch.Tensor, plan: NttPlan, unordered: bool = False,
            plain: bool = False) -> torch.Tensor:
    """'radix4-vec' inverse (strict), for inputs below 8q; with unordered
    the input in the unordered forward's order."""
    return run(a, plan, vec_inv_launches(plan.n, unordered), 64, plain)
