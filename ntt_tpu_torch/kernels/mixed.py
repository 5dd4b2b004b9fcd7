"""The mixed-radix 'r4r2' transforms: radix-4 stages on K10, a radix-2
tail on K9.

The counterpart of ``ntt_tpu/kernels/mixed.py``: k radix-4 sweeps while
the butterfly span is large, then a tail of r radix-2 stages, r = 4 for
even log2 N and 3 for odd (``stage_plan``, mixed.py:33); the tail's first
stage reduces its inputs 8q -> 4q (where k > 0), so the lazy output stays
below 4q.  Forward at word 64 over the 2N ``expand_w`` table and the
plain bit-reversed one (:49-115), or, as the JAX package dispatches for
N >= 128 at word 64, over the 5N ``expand_w_r4r2`` layout, whose tail
segments are read through their duplications and lane orders
(:117-199); at word 32 (q < 2^28) over the 2N and plain tables
(:260-324).  The inverse (:200-258) runs the tail backwards on K9, then
the radix-4 stages backwards on K10, and scales by n^-1.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import twiddles as tw
from ntt_tpu_torch.kernels import radix2 as r2
from ntt_tpu_torch.kernels import radix4 as r4
from ntt_tpu_torch.plan import NttPlan

TABLE_MIN_N = 128  # the 5N layout needs N >= 128


def stage_plan(logn: int) -> tuple[int, int]:
    """(k, r): k radix-4 sweeps, then r radix-2 stages (all radix-2 where
    N is too small for a sweep)."""
    r = 4 if logn % 2 == 0 else 3
    k = (logn - r) // 2
    return (0, logn) if k < 0 else (k, r)


def fwd_launches(n: int, strict: bool, table: bool) -> list[r2.Launch]:
    """The forward; with table (word 64, N >= 128) over the 5N layout."""
    logn = n.bit_length() - 1
    k, r = stage_plan(logn)
    out = []
    if table:
        r4_runs, tail = tw.r4r2_regions(n)
        for m, base in sorted(r4_runs.items()):
            out.append(r4.k10(r4.R4Stage(lt=(n // (4 * m)).bit_length() - 1,
                                         tw=r4.TW_REGION, base=base), "w_r4r2"))
        views = {"r2": {}, "r2x4": dict(gs=4, js=1), "r2t2": dict(gs=2, js=1, perm=r2.PERM_T2),
                 "r2t1": dict(perm=r2.PERM_T1)}
        for kind, m, base in tail:
            out.append(r2.k9(r2.R2Stage(lt=(n // (2 * m)).bit_length() - 1, base=base,
                                        view="r4r2", **views[kind]), "w_r4r2"))
    else:
        for s in range(k):
            out.append(r4.k10(r4.R4Stage(lt=logn - 2 - 2 * s), "w_r4"))
        for s in range(2 * k, logn):
            out.append(r2.k9(r2.R2Stage(lt=logn - 1 - s, base=1 << s), "w"))
    if k:
        out = r2.with_stage(out, k, pre=r2.PRE_8Q_4Q)
    return r2.with_stage(out, -1, post=r2.POST_4Q_Q) if strict else out


def inv_launches(n: int) -> list[r2.Launch]:
    """The inverse: r backward radix-2 stages m = N/2, ... on the inverse
    table, then k inverse radix-4 stages on the inverse 2N table; the last
    stage scaled by n^-1, strict."""
    logn = n.bit_length() - 1
    k, r = stage_plan(logn)
    out = [r2.k9(r2.R2Stage(lt=s, mode=r2.BKW, base=n >> (s + 1)), "w_inv") for s in range(r)]
    for s in range(k):
        out.append(r4.k10(r4.R4Stage(lt=logn - 2 * k + 2 * s, mode=r4.R4_INV), "w_inv_r4"))
    return r2.with_stage(out, -1, post=r4.POST_NINV if k else r2.POST_NINV)


def uses_table(plan: NttPlan, word: int) -> bool:
    """The JAX dispatch: the 5N layout at word 64 from N = 128."""
    return word == 64 and plan.n >= TABLE_MIN_N


def fwd(a: torch.Tensor, plan: NttPlan, word: int, strict: bool = True,
        plain: bool = False) -> torch.Tensor:
    """'r4r2' forward at word 32 or 64: strict, or lazy (< 4q)."""
    launches = fwd_launches(plan.n, strict, uses_table(plan, word))
    return r2.run(a, plan, launches, word, plain)


def inv(a: torch.Tensor, plan: NttPlan, word: int, plain: bool = False) -> torch.Tensor:
    """'r4r2' inverse (strict)."""
    return r2.run(a, plan, inv_launches(plan.n), word, plain)
