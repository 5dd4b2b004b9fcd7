"""The two-pass six-step: CUDA kernels K4 to K7 and their wrappers.

For N beyond one block's shared memory (m >= 15 at word 64, m >= 16 at
word 32) each transform runs as two passes over device memory on the
(N1, N2) view of a polynomial (``csrc/ntt_sixstep.cu`` has the design):

  * K4 ``fwd_cols``: the forward column stages (JAX ``sixstep.fwd_phase1``,
    ntt_tpu/kernels/sixstep.py:259, XLA code on the TPU);
  * K5 ``fwd_rows``: the forward row stages with the strict reduce and,
    with keep_transposed, the (N2, N1) output layout (``fwd_phase2`` :294
    with the transposes of ``fwd_sixstep``);
  * K6 ``inv_rows``: the reversed row stages, from the (N1, N2) or the
    (N2, N1) layout (the Pallas ``_inv_rows_kernel``,
    ntt_tpu/kernels/pallas_fused.py:286);
  * K7 ``inv_cols``: the reversed column stages and the fused n^-1 stage
    (the Pallas ``_inv_cols_kernel``, pallas_fused.py:307).

What bounds them on an H100: device memory, one read and one write of
every coefficient per pass, plus the row twiddles in the row passes.
Every pass takes ``n1_log`` (N1 = 2^n1_log); the API passes the JAX
package's split (``sixstep.word_split``), which fixes the transposed layout.

A wrapper runs the plain PyTorch version (``kernels/sixstep.py``) for a
tensor on the CPU and the kernel for a tensor on a CUDA device; it never
falls back from one to the other.  ``LAUNCHES`` counts the kernel launches
per kernel and width.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import native
from ntt_tpu_torch.kernels import sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import SMEM_BYTES, cuda_batch
from ntt_tpu_torch.plan import NttPlan

# Shared memory a tile aims at: small enough for several blocks per SM.
TILE_BYTES = 32 * 1024
SECTOR_BYTES = 32  # one DRAM sector: the least a coalesced access should move

LAUNCHES = {f"{k}_u{w}": 0 for k in ("fwd_cols", "fwd_rows", "inv_rows", "inv_cols")
            for w in (32, 64)}


def row_pitch(n2_log: int, tr_log: int, word: int) -> int:
    """Words between two rows of a row tile (``row_pitch`` in the source)."""
    return (1 << n2_log) + max(1, 128 // ((word // 8) << tr_log))


def tile_log(n1_log: int, n2_log: int, word: int, rows: bool) -> int:
    """log2 of the columns (TC) a column tile holds, or with rows, of the
    rows (TR) a row tile holds: at least a sector's worth of words, more
    while the tile stays within TILE_BYTES, at most the whole other axis;
    fewer only where shared memory forces it."""
    size = word // 8
    axis_log, other_log = (n2_log, n1_log) if rows else (n1_log, n2_log)

    def tile_bytes(lg):
        words = row_pitch(n2_log, lg, word) << lg if rows else 1 << (axis_log + lg)
        return words * size

    lg = (SECTOR_BYTES // size).bit_length() - 1
    while lg < other_log and tile_bytes(lg + 1) <= TILE_BYTES:
        lg += 1
    lg = min(lg, other_log)
    while lg > 0 and tile_bytes(lg) > SMEM_BYTES:
        lg -= 1
    if tile_bytes(lg) > SMEM_BYTES:
        raise ValueError(f"a {'row' if rows else 'column'} of 2^{axis_log} words of "
                         f"{word} bits exceeds one block's shared memory")
    return lg


def _logs(plan: NttPlan, n1_log: int) -> tuple[int, int]:
    if not 1 <= n1_log <= plan.m:
        raise ValueError(f"n1_log={n1_log} outside [1, {plan.m}] for N=2^{plan.m}")
    return n1_log, plan.m - n1_log


def _launch(kernel: str, a: torch.Tensor, plan: NttPlan, before: tuple,
            after: tuple) -> torch.Tensor:
    """Launch ``kernel`` at the plan's width into a new output; its launcher
    takes (in, out, *before, batch, *after, stream)."""
    batch = cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    name = f"{kernel}_u{plan.word}"
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), *before, batch, *after,
                      native.stream(a.device))
    LAUNCHES[name] += 1
    return out


def fwd_cols(a: torch.Tensor, plan: NttPlan, n1_log: int) -> torch.Tensor:
    """K4: forward column stages of (..., N) in the (N1, N2) layout; lazy
    output (< 4q) in the same layout."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = plan.device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.fwd_cols(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q, n1_log)
    tc = tile_log(n1_log, n2_log, plan.word, rows=False)
    return _launch("fwd_cols", a, plan, (tabs.w.data_ptr(), tabs.w_con.data_ptr(), plan.q),
                   (n1_log, n2_log, tc))


def fwd_rows(a: torch.Tensor, plan: NttPlan, n1_log: int, strict: bool = True,
             keep_transposed: bool = False) -> torch.Tensor:
    """K5: forward row stages of fwd_cols' output; (N1, N2) layout out, or
    (N2, N1) with keep_transposed; < q with strict, else < 4q."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = plan.device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.fwd_rows(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q, n1_log,
                                strict, keep_transposed)
    tr = tile_log(n1_log, n2_log, plan.word, rows=True)
    return _launch("fwd_rows", a, plan, (tabs.w.data_ptr(), tabs.w_con.data_ptr(), plan.q),
                   (n1_log, n2_log, tr, int(strict), int(keep_transposed)))


def inv_rows(a: torch.Tensor, plan: NttPlan, n1_log: int,
             input_transposed: bool = False) -> torch.Tensor:
    """K6: inverse row stages of (..., N) in the (N1, N2) layout, or the
    (N2, N1) layout with input_transposed; (N1, N2) layout out."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = plan.device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.inv_rows(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con,
                                plan.q, n1_log, input_transposed)
    tr = tile_log(n1_log, n2_log, plan.word, rows=True)
    return _launch("inv_rows", a, plan,
                   (tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), plan.q),
                   (n1_log, n2_log, tr, int(input_transposed)))


def inv_cols(a: torch.Tensor, plan: NttPlan, n1_log: int) -> torch.Tensor:
    """K7: inverse column stages and the fused n^-1 stage of inv_rows'
    output; strict output in the standard order."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = plan.device_tables(a.device)
    n_inv, n_inv_con, f_tmp, f_con = plan.inv_consts
    if native.route(a) == "cpu":
        return sixstep.inv_cols(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con, n_inv,
                                n_inv_con, f_tmp, f_con, plan.q, n1_log)
    tc = tile_log(n1_log, n2_log, plan.word, rows=False)
    mask = (1 << plan.word) - 1
    return _launch("inv_cols", a, plan,
                   (tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), plan.q, n_inv,
                    n_inv_con, f_tmp, f_con & mask, f_con >> plan.word),
                   (n1_log, n2_log, tc))
