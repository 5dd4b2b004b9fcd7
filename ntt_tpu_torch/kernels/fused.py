"""Fused forward and inverse NTT: CUDA kernels K1 / K2 and their wrappers.

The counterpart of ``ntt_tpu/kernels/pallas_fused.py``.  The whole
transform of a polynomial stays on chip, in one launch:

  * K1 ``fwd_fused`` replaces the Pallas ``_fwd_kernel``
    (pallas_fused.py:230);
  * K2 ``inv_fused`` replaces ``_inv_kernel`` (:257).  The JAX word-64
    inverse runs it as two launches, ``_inv_rows_kernel`` (:286) and
    ``_inv_cols_kernel`` (:307); K2 computes both in one residency, and
    the two-pass kernels K6 / K7 (``kernels/twopass.py``) port the two.

What bounds them on an H100: one block holds one polynomial (N words of 4
or 8 bytes in shared memory between rounds; at most 227 KB a block), so N
is capped at 2^14 at word 64 and 2^15 at word 32 (beyond that the two-pass
kernels of ``kernels/twopass.py`` serve).  Device memory sees one load
and one store per coefficient; each butterfly costs one Shoup multiply,
about 29 SASS instructions at word 64 and 9 at word 32, which makes the
word-64 transform as much arithmetic as memory.  Their first design ran
each of the log2 N stages as a pass over shared memory behind a barrier;
the register rounds of ``csrc/rounds.cuh`` run 4 stages a round in
registers (three exchanges through shared memory at N = 2^14), read
device memory straight into registers and read each twiddle pair once a
round.  Design notes are in ``csrc/ntt_fused.cu``.

A wrapper runs the plain PyTorch version (``kernels/sixstep.py``) for a
tensor on the CPU and the kernel for a tensor on a CUDA device; it never
falls back from one to the other.  ``LAUNCHES`` counts the kernel launches
per kernel and width.

Under the NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``), at a q of
the Solinas form of the plan's word (``modmath.solinas_args``), a wrapper
launches the kernel's Solinas instantiation (``csrc/modarith.cuh``'s
SolinasRed), which reads no w_con table, and counts it in
``SOLINAS_LAUNCHES``; the plain versions follow the same switch.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native
from ntt_tpu_torch.kernels import sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.plan import NttPlan

# Dynamic shared memory a block can use on Hopper: 227 KB (NVIDIA's Hopper
# architecture documentation), above 48 KB only after cudaFuncSetAttribute.
SMEM_BYTES = 232448

LAUNCHES = {"fwd_fused_u32": 0, "fwd_fused_u64": 0, "inv_fused_u32": 0,
            "inv_fused_u64": 0}
SOLINAS_LAUNCHES = {f"{k}_solinas_u{w}": 0 for k in ("fwd_fused", "inv_fused") for w in (32, 64)}


def max_logn(word: int) -> int:
    """Largest m with N = 2^m words of `word` bits in one block."""
    return (SMEM_BYTES // (word // 8)).bit_length() - 1


def cuda_batch(a: torch.Tensor, plan: NttPlan) -> int:
    """Check a CUDA input against what the transform kernels take (the
    plan's dtype, last dim N, contiguous); return the batch."""
    if a.dtype != plan.dtype:
        raise TypeError(f"expected {plan.dtype} for q={plan.q:#x}, got {a.dtype}")
    if a.dim() < 1 or a.shape[-1] != plan.n:
        raise ValueError(f"last dim must be N={plan.n}, got shape {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("the transform kernels take a contiguous tensor")
    return a.numel() // plan.n


def _cuda_batch(a: torch.Tensor, plan: NttPlan) -> int:
    """cuda_batch, and N must fit one block's shared memory."""
    if plan.m > max_logn(plan.word):
        raise ValueError(
            f"N=2^{plan.m} at word {plan.word} exceeds one block's shared memory "
            f"({SMEM_BYTES} bytes): use the two-pass 'sixstep' variant"
        )
    return cuda_batch(a, plan)


def fwd_fused(a: torch.Tensor, plan: NttPlan, strict: bool = True) -> torch.Tensor:
    """Forward NTT of (..., N): natural order in, bit-reversed out; output
    < q with strict, else the lazy Harvey representatives < 4q."""
    tabs = plan.device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.fwd_sixstep(a, pick_ops(plan.q), tabs.w, tabs.w_con,
                                   plan.q, sixstep.balanced_split(plan.n), strict=strict)
    batch = _cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    sol = mm.solinas_args(plan.q, plan.word)
    name = native.entry("fwd_fused", plan.word, sol)
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), tabs.w.data_ptr(),
                      None if sol else tabs.w_con.data_ptr(), plan.q, batch, plan.m,
                      int(strict), *(sol or ()), native.stream(a.device))
    (SOLINAS_LAUNCHES if sol else LAUNCHES)[name] += 1
    return out


def inv_fused(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse NTT of (..., N): bit-reversed in, natural out, strict."""
    tabs = plan.device_tables(a.device)
    n_inv, n_inv_con, f_tmp, f_con = plan.inv_consts
    if native.route(a) == "cpu":
        return sixstep.inv_sixstep(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con,
                                   n_inv, n_inv_con, f_tmp, f_con, plan.q,
                                   sixstep.balanced_split(plan.n))
    batch = _cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    sol = mm.solinas_args(plan.q, plan.word)
    name = native.entry("inv_fused", plan.word, sol)
    mask = (1 << plan.word) - 1
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), tabs.w_inv.data_ptr(),
                      None if sol else tabs.w_inv_con.data_ptr(), plan.q, n_inv, n_inv_con,
                      f_tmp, f_con & mask, f_con >> plan.word, batch, plan.m, *(sol or ()),
                      native.stream(a.device))
    (SOLINAS_LAUNCHES if sol else LAUNCHES)[name] += 1
    return out
