"""The lab's transform candidates: CUDA kernels L1 / L2, their plain PyTorch
versions and their wrappers.

The counterpart of the Pallas lab's transform kernels
(``tools/pallas_lab.py``), the same function as K1 (``kernels/fused.py``):
natural order in, bit-reversed out, with the stages grouped otherwise.

  * L1 ``fwd_fused_v2`` replaces ``_fwd_kernel_v2`` (pallas_lab.py:127,
    called through ``fwd_fused_v2`` :166): K1's radix-2 stages in place, in
    six-step rounds.  The column phase (log2 N1 stages) and the row phase
    (log2 N2) each run the rounds of ``make_rounds`` (:93): ``group=1`` one
    stage a round, ``group=2`` two (a one-stage round where the phase has
    an odd stage count); no round crosses the phase boundary.
  * L2 ``fwd_fused_v3`` replaces ``_fwd_kernel_v3`` (:326, called through
    ``fwd_fused_v3`` :353): the Stockham constant-geometry flow.  Every
    stage pairs the two halves of the phase's axis and writes the results
    interleaved; the column twiddle of stage s for pair i is
    w[2^s + (i mod 2^s)], the row twiddle of row-stage s for pair i in
    column c is w[2^s N1 + c 2^s + (i mod 2^s)] (``stockham_col_stack`` /
    ``stockham_row_stack`` :277-298).  The kernel computes those indices
    into the plan's flat tables; no pre-broadcast stack is built.

Both kernels run at K1's design point (``csrc/rounds.cuh``: 16 words a
thread in registers, at most 512 threads, the padded exchange buffer
between rounds, a coalesced first load and copy-out), so K1, L1 and L2
differ only in where their rounds fall: K1 runs rounds of four stages,
L1 rounds of ``group`` stages that stop at the N1 | N2 boundary, L2 rounds
of up to four Stockham stages that read the same 16 positions of the
phase's axis every round.  Every coefficient meets the butterflies of the
flat radix-2 transform with the same twiddles, so L1 and L2 give K1's
bits, lazy representatives included, at any split; ``n1_log`` sets the
round structure (where a phase ends) and the ``keep_transposed`` layout,
(N2, N1).  Their plain version is therefore the plain six-step at the
same split, ``plain`` below (``sixstep.fwd_sixstep``).  The Pallas lab's
``use_scratch`` (its VMEM ping-pong pair) and ``tile_b`` change no bit and
have no counterpart; the design is in ``csrc/ntt_lab.cu``.  Both wrappers
refuse, on the card, an N beyond one block's shared memory
(``fused.max_logn``), as K1's do.

A wrapper runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; it never falls back from one to the other.
Each call is a kernel span (``trace.py``); ``native.launch`` counts each
launch in ``trace.LAUNCHES``, and L1 again under its rounds' group
(``fwd_fused_v2_r2`` / ``_r4`` at the width, the lab's names).

Under the NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``, read at every
call), at a q of the Solinas form of the plan's word
(``modmath.solinas_args``), every butterfly takes the Solinas product, as
the JAX lab's ``ops.fwd_bfly`` does there: a wrapper launches the kernel's
Solinas instantiation (``csrc/modarith.cuh``'s SolinasRed), which reads no
w_con table; the plain version
follows the same switch.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native, trace
from ntt_tpu_torch.kernels import sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import _cuda_batch
from ntt_tpu_torch.plan import NttPlan

KERNELS = ("fwd_fused_v2_r2", "fwd_fused_v2_r4", "fwd_fused_v3")


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
    """Launch ``name`` at the plan's width, in its Solinas instantiation
    where the switch takes the plan's q, and count it again under ``count``
    where that is another name."""
    batch = _cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    tabs = plan.device_tables(a.device)
    sol = mm.solinas_args(plan.q, plan.word)
    with torch.cuda.device(a.device):
        native.launch(native.entry(name, plan.word, sol), a.data_ptr(), out.data_ptr(),
                      tabs.w.data_ptr(), None if sol else tabs.w_con.data_ptr(), plan.q,
                      batch, plan.m, n1_log, *args, *(sol or ()), native.stream(a.device))
    if count != name:
        trace.LAUNCHES[native.entry(count, plan.word, sol)] += 1
    return out


@trace.traced("kernel")
def fwd_fused_v2(a: torch.Tensor, plan: NttPlan, n1_log: int, group: int = 2,
                 strict: bool = True, keep_transposed: bool = False) -> torch.Tensor:
    """L1: forward NTT of (..., N) in rounds of ``group`` stages; output as
    ``fused.fwd_fused``'s or, with keep_transposed, in the (N2, N1) layout."""
    sixstep._split(plan.n, n1_log)
    if group not in (1, 2):
        raise ValueError(f"group must be 1 or 2, got {group}")
    if native.route(a) == "cpu":
        return plain(a, plan, n1_log, strict, keep_transposed)
    return _launch("fwd_fused_v2", f"fwd_fused_v2_r{2 * group}", a, plan, n1_log, group,
                   int(strict), int(keep_transposed))


@trace.traced("kernel")
def fwd_fused_v3(a: torch.Tensor, plan: NttPlan, n1_log: int, strict: bool = True,
                 keep_transposed: bool = False) -> torch.Tensor:
    """L2: forward NTT of (..., N) by Stockham stages; outputs as
    fwd_fused_v2's."""
    sixstep._split(plan.n, n1_log)
    if native.route(a) == "cpu":
        return plain(a, plan, n1_log, strict, keep_transposed)
    return _launch("fwd_fused_v3", "fwd_fused_v3", a, plan, n1_log, int(strict),
                   int(keep_transposed))
