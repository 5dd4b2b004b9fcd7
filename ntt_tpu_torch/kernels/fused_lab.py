"""The lab's transform candidates: CUDA kernels L1 / L2, their plain PyTorch
versions and their wrappers.

The counterpart of the Pallas lab's transform kernels
(``tools/pallas_lab.py``), the same function as K1 (``kernels/fused.py``):
natural order in, bit-reversed out, with the stages grouped otherwise.

  * L1 ``fwd_fused_v2`` replaces ``_fwd_kernel_v2`` (pallas_lab.py:127,
    called through ``fwd_fused_v2`` :166).  The column phase (log2 N1
    stages) and the row phase (log2 N2) each run the rounds of
    ``make_rounds`` (:93):
    ``group=1`` one radix-2 stage a round, ``group=2`` two stages a
    round (a radix-2 tail round where the phase has an odd stage count).
    A two-stage round over m groups of four quarters c0..c3 pairs (c0, c2)
    and (c1, c3) under w[m + g], then (c0, c1) under w[2m + 2g] and
    (c2, c3) under w[2m + 2g + 1] (``_round_r4`` :67).
  * L2 ``fwd_fused_v3`` replaces ``_fwd_kernel_v3`` (:326, called through
    ``fwd_fused_v3`` :353): the Stockham constant-geometry flow.  Every
    stage pairs the contiguous halves of the phase's axis and writes the
    results interleaved; the column twiddle of stage s for pair i is
    w[2^s + (i mod 2^s)], the row twiddle of row-stage s for pair i in
    column c is w[2^s N1 + c 2^s + (i mod 2^s)] (``stockham_col_stack`` /
    ``stockham_row_stack`` :277-298).  The kernel computes those indices
    into the plan's flat tables; no pre-broadcast stack is built.

Every coefficient meets the butterflies of the flat radix-2 transform with
the same twiddles, so L1 and L2 give K1's bits, lazy representatives included,
at any split; ``n1_log`` sets the round structure (where a phase ends) and
the ``keep_transposed`` layout, (N2, N1).  Their plain version is
therefore the plain six-step at the same split, ``plain`` below
(``sixstep.fwd_sixstep``).  The Pallas lab's ``use_scratch`` (its VMEM
ping-pong pair) and ``tile_b`` change no bit and have no counterpart; the
design is in ``csrc/ntt_lab.cu``.

A wrapper runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; it never falls back from one to the other.
``LAUNCHES`` counts the kernel launches per kernel and width.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native
from ntt_tpu_torch.kernels import sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import _cuda_batch
from ntt_tpu_torch.plan import NttPlan

LAUNCHES = {f"{k}_u{w}": 0 for k in ("fwd_fused_v2_r2", "fwd_fused_v2_r4", "fwd_fused_v3")
            for w in (32, 64)}


def refuse_switch(plan: NttPlan) -> None:
    """Raise where the NTT_MULMOD=solinas switch changes the plan's single
    product (``modmath.solinas_args``): the lab's kernels L1-L3 have no
    Solinas instantiation, and the lab computes nothing rather than the
    Shoup bits beside a plain side that computes the Solinas ones."""
    if mm.solinas_args(plan.q, plan.word) is not None:
        raise RuntimeError(
            f"the lab's kernels have no Solinas instantiation: q={plan.q:#x} takes the "
            "Solinas product under NTT_MULMOD=solinas (modmath.USE_SOLINAS); turn the "
            "switch off for the lab")


def plain(a: torch.Tensor, plan: NttPlan, n1_log: int, strict: bool = True,
          keep_transposed: bool = False) -> torch.Tensor:
    """The plain version of L1 and L2: the six-step at split n1_log."""
    tabs = plan.device_tables(a.device)
    return sixstep.fwd_sixstep(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q, n1_log,
                               strict, keep_transposed)


def plain_inv(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """The plain version of K2 in the lab: the plain inverse six-step
    (``fused.inv_fused``'s CPU route) on a's device."""
    tabs = plan.device_tables(a.device)
    return sixstep.inv_sixstep(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con,
                               *plan.inv_consts, plan.q, sixstep.balanced_split(plan.n))


def _launch(name: str, count: str, a: torch.Tensor, plan: NttPlan, n1_log: int,
            *args) -> torch.Tensor:
    """Launch ``name`` at the plan's width and add one to LAUNCHES[count]."""
    batch = _cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    tabs = plan.device_tables(a.device)
    with torch.cuda.device(a.device):
        native.launch(f"{name}_u{plan.word}", a.data_ptr(), out.data_ptr(),
                      tabs.w.data_ptr(), tabs.w_con.data_ptr(), plan.q, batch, plan.m,
                      n1_log, *args, native.stream(a.device))
    LAUNCHES[f"{count}_u{plan.word}"] += 1
    return out


def fwd_fused_v2(a: torch.Tensor, plan: NttPlan, n1_log: int, group: int = 2,
                 strict: bool = True, keep_transposed: bool = False) -> torch.Tensor:
    """L1: forward NTT of (..., N) in rounds of ``group`` stages; output as
    ``fused.fwd_fused``'s or, with keep_transposed, in the (N2, N1) layout."""
    sixstep._split(plan.n, n1_log)
    refuse_switch(plan)
    if group not in (1, 2):
        raise ValueError(f"group must be 1 or 2, got {group}")
    if native.route(a) == "cpu":
        return plain(a, plan, n1_log, strict, keep_transposed)
    return _launch("fwd_fused_v2", f"fwd_fused_v2_r{2 * group}", a, plan, n1_log, group,
                   int(strict), int(keep_transposed))


def fwd_fused_v3(a: torch.Tensor, plan: NttPlan, n1_log: int, strict: bool = True,
                 keep_transposed: bool = False) -> torch.Tensor:
    """L2: forward NTT of (..., N) by Stockham stages; outputs as
    fwd_fused_v2's."""
    sixstep._split(plan.n, n1_log)
    refuse_switch(plan)
    if native.route(a) == "cpu":
        return plain(a, plan, n1_log, strict, keep_transposed)
    return _launch("fwd_fused_v3", "fwd_fused_v3", a, plan, n1_log, int(strict),
                   int(keep_transposed))
