"""The two-level (recursive) six-step: CUDA kernel K8 ``twist_mul``, its
wrapper, and the transforms ``fwd_rec`` / ``inv_rec`` built of launches.

The counterpart of ``ntt_tpu/kernels/sixstep.py``'s ``fwd_rec`` /
``inv_rec`` (:478-519).  With N = N1 * N2, N1 = 2^(m // 2), both levels
are full negacyclic NTTs, glued by the twist gamma_c^n2 of
``twiddles.twist_tables_rec``:

  * forward: K4 ``fwd_cols`` at split N1 (the size-N1 transforms of the
    columns of the (N1, N2) view are exactly the flat transform's first
    log2 N1 stages, read from the level-1 plan's tables, which are the
    global table's prefix), K8 with the forward twist, then the size-N2
    transform of the batch * N1 rows on the level-2 plan through the
    API's ``auto`` (K1 wherever N2 fits one block: every m up to 28 at
    word 64);
  * inverse: the size-N2 inverse of the rows (K2, scaling by 1/N2), K8
    with the inverse twist, then K7 ``inv_cols`` with the level-1 plan's
    constants (1/N1).

The layouts between the launches are views of one contiguous tensor, so
nothing is transposed.  K8 (``csrc/twist.cu``) replaces the reference's
``_twist_mul`` (sixstep.py:465, XLA code on the TPU); it is bound by
device memory.

The wrapper runs the plain PyTorch version (``sixstep.twist_mul``) for a
tensor on the CPU and the kernel for a tensor on a CUDA device; it never
falls back from one to the other.  ``LAUNCHES`` counts the kernel launches
per width.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import native
from ntt_tpu_torch.kernels import sixstep, twopass
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import cuda_batch
from ntt_tpu_torch.plan import NttPlan

LAUNCHES = {"twist_mul_u32": 0, "twist_mul_u64": 0}


def twist_mul(a: torch.Tensor, plan: NttPlan, l1_log: int,
              inverse: bool = False) -> torch.Tensor:
    """K8: (..., N) in the (N1, N2) layout, N1 = 2^l1_log, times the
    forward twist (or with inverse, the inverse twist); inputs < 4q,
    outputs < 2q."""
    if not 0 <= l1_log <= plan.m:
        raise ValueError(f"l1_log={l1_log} outside [0, {plan.m}] for N=2^{plan.m}")
    tw = plan.device_tables(a.device).twist(l1_log, inverse)
    if native.route(a) == "cpu":
        return sixstep.twist_mul(a, pick_ops(plan.q), tw, plan.q)
    batch = cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    name = f"twist_mul_u{plan.word}"
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tw), plan.q,
                      batch, plan.m, l1_log, native.stream(a.device))
    LAUNCHES[name] += 1
    return out


def _levels(plan: NttPlan) -> tuple[int, NttPlan, NttPlan]:
    if plan.m < 2:
        raise ValueError(f"the two-level six-step needs m >= 2, got m={plan.m}")
    l1 = sixstep.rec_split(plan.m)
    return (l1, *plan.rec_plans(l1))


def _rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N) as (..., N1, N2): the level-2 transform's rows."""
    return a.reshape(a.shape[:-1] + (-1, n))


def _level2(plan2: NttPlan, inverse: bool = False):
    from ntt_tpu_torch import api  # api registers this module's transforms

    return api._pick(plan2, "auto", inverse)


def fwd_rec(a: torch.Tensor, plan: NttPlan, strict: bool = True) -> torch.Tensor:
    """Forward NTT of a contiguous (..., N) tensor through the two levels:
    natural order in, bit-reversed out; < q with strict, else the lazy
    representatives of the level-2 forward (< 4q)."""
    l1, plan1, plan2 = _levels(plan)
    x = twopass.fwd_cols(a, plan, l1, col_plan=plan1)
    x = twist_mul(x, plan, l1)
    return _level2(plan2).fwd(plan2, _rows(x, plan2.n), not strict).reshape(a.shape)


def inv_rec(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse of fwd_rec (strict output): the level-2 inverse of the rows
    (1/N2), the inverse twist, the level-1 inverse of the columns (1/N1)."""
    l1, plan1, plan2 = _levels(plan)
    x = _level2(plan2, inverse=True).inv(plan2, _rows(a, plan2.n)).reshape(a.shape)
    x = twist_mul(x, plan, l1, inverse=True)
    return twopass.inv_cols(x, plan, l1, col_plan=plan1)


def plain_fwd(a: torch.Tensor, plan: NttPlan, strict: bool = True) -> torch.Tensor:
    """fwd_rec's plain version on a's device: the plain column stages,
    twist and level-2 six-step, for holding the launches against it on the
    card."""
    l1, plan1, plan2 = _levels(plan)
    ops, t1, t2 = pick_ops(plan.q), plan1.device_tables(a.device), plan2.device_tables(a.device)
    x = sixstep.fwd_cols(a, ops, t1.w, t1.w_con, plan.q, l1)
    x = sixstep.twist_mul(x, ops, plan.device_tables(a.device).twist(l1, False), plan.q)
    x = sixstep.fwd_sixstep(_rows(x, plan2.n), ops, t2.w, t2.w_con, plan.q,
                            sixstep.balanced_split(plan2.n), strict=strict)
    return x.reshape(a.shape)


def plain_inv(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """inv_rec's plain version on a's device."""
    l1, plan1, plan2 = _levels(plan)
    ops, t1, t2 = pick_ops(plan.q), plan1.device_tables(a.device), plan2.device_tables(a.device)
    x = sixstep.inv_sixstep(_rows(a, plan2.n), ops, t2.w_inv, t2.w_inv_con, *plan2.inv_consts,
                            plan.q, sixstep.balanced_split(plan2.n)).reshape(a.shape)
    x = sixstep.twist_mul(x, ops, plan.device_tables(a.device).twist(l1, True), plan.q)
    return sixstep.inv_cols(x, ops, t1.w_inv, t1.w_inv_con, *plan1.inv_consts, plan.q, l1)
