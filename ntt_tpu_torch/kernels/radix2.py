"""Radix-2 Harvey transforms of the reference's families: CUDA kernel K9
``r2_stage``, its wrapper and plain version, and the transforms built of
its launches.

The counterpart of ``ntt_tpu/kernels/radix2.py``: the forward and inverse
of 'radix2' (word 64, :65-169) and 'radix2-u32' (word 32, :343-395),
SEAL's forward (:192-209, the same values as the Harvey chain) and its
own inverse, whose final stage guards x before the sum, scales the sum by
n^-1 without the lazy reduction, multiplies the difference by
scaled_r = n^-1 * w_inv[1] and ends in a 2q -> q sweep (:210-268), and
the forwards that read the HEXL 13N/8 and r2_16 3N layouts (:270-341).
``kernels/mixed.py`` runs its radix-2 tail on K9 as well.

A transform is a list of ``Launch``es, one a stage, each a stage
descriptor (``R2Stage`` here, ``radix4.R4Stage``) with the names of the
plan tables it reads; ``run`` sends the list through the kernels, or with
``plain`` through their plain versions.  A stage of N = 2^logn words
pairs word i0 with i0 + t, t = 2^lt, in m = N / 2t groups; group g reads
its twiddle at ``base + perm(g) * gs + j * js`` (j < t its butterfly in
the group), which covers the plain bit-reversed table (base m, gs 1,
js 0) and the duplicated and lane-permuted segments of the HEXL, r2_16
and r4r2 layouts.  Stage modes: forward butterfly, backward butterfly,
the fused n^-1 final stage (``elems.*Ops.bkw_final``) and SEAL's final
stage; ``pre`` reduces both inputs 8q -> 4q (the r4r2 tail's first
stage), ``post`` reduces the outputs 4q -> q (a strict forward) or scales
them by n^-1 with a strict result (an inverse whose last stage is not a
final stage).

K9 (``csrc/r2_stage.cu``) replaces the JAX package's jnp stages
(radix2.py:65, :99, :192, :210, :307, :343, :365 and mixed.py's radix-2
tail), which XLA fused a stage at a time on the TPU.  One launch a stage,
one thread a butterfly, over device memory: each stage reads and writes
every word once, so a transform moves log2 N times the words of one pass
and is bound by device memory.  Holding the transform on chip through its
stages, as K1 does, is later work.

The wrapper runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; it never falls back from one to the other.
Each call is a kernel span (``trace.py``); ``native.launch`` counts each
launch in ``trace.LAUNCHES``, and the wrapper again under
``mode/<launcher>/<stage mode>/<twiddle view>``.  Under the
NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``), at a q of the
Solinas form of the stage's word, the wrapper launches K9's Solinas
instantiation, which reads no Shoup constant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native, trace
from ntt_tpu_torch import twiddles as tw
from ntt_tpu_torch.kernels.elems import ops_at
from ntt_tpu_torch.plan import NttPlan, final_mulop

FWD, BKW, FINAL, SEAL_FINAL = 0, 1, 2, 3  # stage modes
PRE_NONE, PRE_8Q_4Q = 0, 1
POST_NONE, POST_4Q_Q, POST_NINV = 0, 1, 2
PERM_NONE, PERM_T1, PERM_T2 = 0, 1, 2  # group order inside blocks of 8 / 4
MODE_NAMES = ("fwd", "bkw", "final", "seal_final")

# The inverses of the r2_16 / r4r2 tail segments' lane orders
# (``ntt_tpu.kernels.radix2._R2_16_T1_INV`` / ``_T2_INV``).
T1_INV = np.argsort(tw.LANE_PERM)
T2_INV = np.argsort(tw.T2_GROUP_ORDER)


@dataclasses.dataclass(frozen=True)
class R2Stage:
    """One radix-2 stage: pairs (i0, i0 + 2^lt); twiddle of group g,
    butterfly j: table[base + perm(g) * gs + j * js]."""

    lt: int
    mode: int = FWD
    pre: int = PRE_NONE
    post: int = POST_NONE
    base: int = 0
    gs: int = 1
    js: int = 0
    perm: int = PERM_NONE
    view: str = "std"  # the table layout it reads, for its mode count


@dataclasses.dataclass(frozen=True)
class Launch:
    """A stage and the plan table it reads (its Shoup constants at the
    word are ``con_name(tab, word)``); ``kernel`` and ``plain`` take
    (a, tab, con, stage, q, word, consts)."""

    kernel: Callable
    plain: Callable
    stage: object
    tab: str


def con_name(tab: str, word: int) -> str:
    """The plan's name for a table's Shoup constants at a word."""
    return tab + {64: "_con", 56: "_con56", 32: "_con32"}[word]


def with_stage(launches: list[Launch], i: int, **change) -> list[Launch]:
    """The launches with the fields of stage i changed."""
    ln = launches[i]
    out = list(launches)
    out[i] = dataclasses.replace(ln, stage=dataclasses.replace(ln.stage, **change))
    return out


def group_perm(g: np.ndarray, perm: int) -> np.ndarray:
    """The group order of a tail segment: group g reads the entries of
    group (g & ~7) | T1_INV[g & 7] (or, T2, (g & ~3) | T2_INV[g & 3])."""
    if perm == PERM_T1:
        return (g & ~7) | T1_INV[g & 7]
    if perm == PERM_T2:
        return (g & ~3) | T2_INV[g & 3]
    return g


def tw_index(st: R2Stage, n: int) -> np.ndarray:
    """(m, t) (or (m, 1) where js is 0) twiddle indices of a stage."""
    t = 1 << st.lt
    g = group_perm(np.arange(n // (2 * t)), st.perm)[:, None]
    j = np.arange(t)[None, :] if st.js else np.zeros((1, 1), dtype=np.int64)
    return st.base + g * st.gs + j * st.js


def _seal_final(ops, x, y, consts, q: int):
    """SEAL's final inverse stage (``ntt_tpu.kernels.radix2.inv_seal_u64``):
    u = guard(x); x' = n_inv * guard(u + y); y' = scaled_r * (u + 2q - y);
    then both 2q -> q."""
    n_inv, n_inv_con, tmp, con = consts
    q2 = ops.const(2 * q)
    u = ops.cond_sub(x, 2 * q)
    nx = ops.shoup_mul(n_inv, n_inv_con, ops.cond_sub(u + y, 2 * q), q)
    d = u + q2 - y
    mask = (1 << ops.word) - 1
    big_q = (mm.mulhi64 if ops.word == 64 else mm.mulhi32)(con & mask, d)
    if con >> ops.word:
        big_q = big_q + d
    ny = ops.const(tmp) * d - big_q * ops.const(q)
    return ops.cond_sub(nx, q), ops.cond_sub(ny, q)


def plain_stage(a: torch.Tensor, tab: torch.Tensor, con: torch.Tensor, st: R2Stage, q: int,
                word: int, consts) -> torch.Tensor:
    """K9's plain version: one stage of (..., N), as the JAX stages."""
    ops = ops_at(word)
    n = a.shape[-1]
    t = 1 << st.lt
    v = a.reshape(a.shape[:-1] + (n // (2 * t), 2, t))
    x, y = v[..., 0, :], v[..., 1, :]
    if st.pre == PRE_8Q_4Q:
        x, y = ops.cond_sub(x, 4 * q), ops.cond_sub(y, 4 * q)
    if st.mode in (FWD, BKW):
        idx = torch.from_numpy(tw_index(st, n)).to(a.device)
        bfly = ops.fwd_bfly if st.mode == FWD else ops.bkw_bfly
        nx, ny = bfly(x, y, tab[idx], con[idx], q)
    elif st.mode == FINAL:
        nx, ny = ops.bkw_final(x, y, *consts, q)
    else:
        nx, ny = _seal_final(ops, x, y, consts, q)
    if st.post == POST_4Q_Q:
        nx, ny = ops.reduce_4q_to_q(nx, q), ops.reduce_4q_to_q(ny, q)
    elif st.post == POST_NINV:
        n_inv, n_inv_con = consts[:2]
        nx, ny = (ops.cond_sub(ops.shoup_mul(n_inv, n_inv_con, z, q), q) for z in (nx, ny))
    return torch.stack([nx, ny], dim=-2).reshape(a.shape)


def stage_dtype(word: int) -> torch.dtype:
    return torch.int32 if word == 32 else torch.int64


def check_cuda(a: torch.Tensor, word: int) -> tuple[int, int]:
    """(rows, log2 N) of a CUDA input the stage kernels take."""
    if a.dtype != stage_dtype(word):
        raise TypeError(f"word {word} takes {stage_dtype(word)}, got {a.dtype}")
    n = a.shape[-1] if a.dim() else 0
    if n < 2 or n & (n - 1) or n > 1 << 30:
        raise ValueError(f"last dim must be a power of two in [2, 2^30], got {n}")
    if not a.is_contiguous():
        raise ValueError("the stage kernels take a contiguous tensor")
    return a.numel() // n, n.bit_length() - 1


@trace.traced("kernel")
def r2_stage(a: torch.Tensor, tab: torch.Tensor, con: torch.Tensor, st: R2Stage, q: int,
             word: int, consts) -> torch.Tensor:
    """K9: one radix-2 stage of (..., N) at Shoup word 32 or 64 (int32 or
    int64 reps), twiddles from ``tab`` / ``con`` (tensors of the same
    dtype); consts = (n_inv, n_inv_con, f_tmp, f_con) of the final modes
    and POST_NINV."""
    if native.route(a) == "cpu":
        return plain_stage(a, tab, con, st, q, word, consts)
    rows, logn = check_cuda(a, word)
    if word not in (32, 64):
        raise ValueError(f"K9 computes at word 32 or 64, not {word}")
    if not 0 <= st.lt < logn:
        raise ValueError(f"stage lt={st.lt} outside [0, {logn}) for N=2^{logn}")
    for t in (tab, con):
        if t.device != a.device or t.dtype != a.dtype or not t.is_contiguous():
            raise ValueError("the twiddle tables must be contiguous, of the input's "
                             "device and dtype")
    out = torch.empty_like(a)
    if rows == 0:
        return out
    n_inv, n_inv_con, f_tmp, f_con = consts
    mask = (1 << word) - 1
    sol = mm.solinas_args(q, word)
    name = native.entry("r2_stage", word, sol)
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), tab.data_ptr(),
                      None if sol else con.data_ptr(), q, rows, logn, st.lt, st.mode, st.pre,
                      st.post, st.base, st.gs, st.js, st.perm, n_inv, n_inv_con, f_tmp,
                      f_con & mask, f_con >> word, *(sol or ()), native.stream(a.device))
    trace.LAUNCHES[f"mode/{name}/{MODE_NAMES[st.mode]}/{st.view}"] += 1
    return out


def consts_at(plan: NttPlan, word: int) -> tuple[int, int, int, int]:
    """(n_inv, n_inv_con, f_tmp, f_con) at Shoup word 32, 56 or 64 (the
    final stage's pair only at 32 and 64, where K9 runs)."""
    n_inv = plan.params.n_inv
    n_inv_con = {32: plan.n_inv_con32, 56: plan.n_inv_con56, 64: plan.n_inv_con}[word]
    if word == 56:
        return n_inv, n_inv_con, 0, 0
    return (n_inv, n_inv_con,
            *final_mulop(n_inv, n_inv_con, int(plan.w_inv[1]), plan.q, word))


def run(a: torch.Tensor, plan: NttPlan, launches: list[Launch], word: int,
        plain: bool = False) -> torch.Tensor:
    """Send (..., N) through the launches, at Shoup word ``word``: the
    kernels (the plain versions on the CPU), or with plain the plain
    versions wherever ``a`` lies."""
    tabs = plan.device_tables(a.device)
    consts = consts_at(plan, word)
    for ln in launches:
        fn = ln.plain if plain else ln.kernel
        a = fn(a, tabs.table(ln.tab, word), tabs.table(con_name(ln.tab, word), word), ln.stage,
               plan.q, word, consts)
    return a


def k9(st: R2Stage, tab: str) -> Launch:
    return Launch(r2_stage, plain_stage, st, tab)


def _view(kind: str, m: int, n: int) -> dict:
    """The twiddle view of forward stage m (m groups) in a table layout
    (``ntt_tpu.kernels.radix2._hexl_tw_view`` / ``_r2_16_tw_view``)."""
    if kind == "std" or 2 * m <= n // 8:
        return dict(base=m)
    if m == n // 8:
        return dict(base=n // 8, gs=4, js=1)
    if m == n // 4:
        if kind == "hexl":
            return dict(base=n // 8 + n // 2, gs=2, js=1)
        return dict(base=5 * n // 8, gs=2, js=1, perm=PERM_T2)
    if kind == "hexl":
        return dict(base=9 * n // 8)
    return dict(base=9 * n // 8, perm=PERM_T1)


VIEW_TABLES = {"std": "w", "hexl": "w_hexl", "r2_16": "w_r2_16"}


def fwd_launches(n: int, strict: bool, view: str = "std") -> list[Launch]:
    """The forward's stages m = 1, 2, ..., N/2, twiddles read through a
    table layout (std, hexl or r2_16; the last two at word 64); strict
    reduces the last stage's outputs 4q -> q."""
    logn = n.bit_length() - 1
    out = []
    for s in range(logn):
        post = POST_4Q_Q if strict and s == logn - 1 else POST_NONE
        out.append(k9(R2Stage(lt=logn - 1 - s, post=post, view=view,
                              **_view(view, 1 << s, n)), VIEW_TABLES[view]))
    return out


def inv_launches(n: int, seal: bool = False) -> list[Launch]:
    """The inverse: backward stages m = N/2, ..., 2 on the inverse table,
    then the fused n^-1 final stage (or SEAL's)."""
    logn = n.bit_length() - 1
    out = [k9(R2Stage(lt=s, mode=BKW, base=n >> (s + 1)), "w_inv") for s in range(logn - 1)]
    out.append(k9(R2Stage(lt=logn - 1, mode=SEAL_FINAL if seal else FINAL), "w_inv"))
    return out


def fwd(a: torch.Tensor, plan: NttPlan, word: int, strict: bool = True,
        plain: bool = False) -> torch.Tensor:
    """'radix2' (word 64) / 'radix2-u32' (word 32) forward: natural in,
    bit-reversed out, strict or lazy (< 4q)."""
    return run(a, plan, fwd_launches(plan.n, strict), word, plain)


def inv(a: torch.Tensor, plan: NttPlan, word: int, plain: bool = False) -> torch.Tensor:
    """'radix2' / 'radix2-u32' inverse (strict); also the inverse of
    'hexl' and 'r2-16', as in the JAX package."""
    return run(a, plan, inv_launches(plan.n), word, plain)


def fwd_seal(a: torch.Tensor, plan: NttPlan, strict: bool = True,
             plain: bool = False) -> torch.Tensor:
    """SEAL's forward (word 64): its main stages m = 1 .. N/4, then the
    last stage m = N/2 (ntt_seal.c's special case); the Harvey chain's
    values, stage for stage."""
    return run(a, plan, fwd_launches(plan.n, strict), 64, plain)


def inv_seal(a: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """SEAL's inverse (word 64, strict), with its own final stage."""
    return run(a, plan, inv_launches(plan.n, seal=True), 64, plain)


def fwd_layout(a: torch.Tensor, plan: NttPlan, view: str, strict: bool = True,
               plain: bool = False) -> torch.Tensor:
    """'hexl' / 'r2-16' forward (word 64): the radix-2 chain with each
    stage's twiddles read from the 13N/8 HEXL or 3N r2_16 layout; inputs
    below 4q (HEXL's input_mod_factor 4)."""
    return run(a, plan, fwd_launches(plan.n, strict, view), 64, plain)
