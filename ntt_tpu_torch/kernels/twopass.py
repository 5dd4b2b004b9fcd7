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
All four run register rounds on their tiles (``csrc/rounds.cuh``), whose
size ``round_tile_log`` picks: K6 takes K5's row tile in the layout it
reads, K7 K4's column tile.

A wrapper runs the plain PyTorch version (``kernels/sixstep.py``) for a
tensor on the CPU and the kernel for a tensor on a CUDA device; it never
falls back from one to the other.  ``LAUNCHES`` counts the kernel launches
per kernel and width; ``SOLINAS_LAUNCHES`` those of the Solinas
instantiations, which a wrapper launches under the NTT_MULMOD=solinas switch
at a q of the Solinas form (``kernels/fused.py``); they read no w_con.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native
from ntt_tpu_torch.kernels import sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import SMEM_BYTES, cuda_batch
from ntt_tpu_torch.plan import NttPlan

SECTOR_BYTES = 32  # one DRAM sector: the least a coalesced access should move

KERNELS = ("fwd_cols", "fwd_rows", "inv_rows", "inv_cols")
LAUNCHES = {f"{k}_u{w}": 0 for k in KERNELS for w in (32, 64)}
SOLINAS_LAUNCHES = {f"{k}_solinas_u{w}": 0 for k in KERNELS for w in (32, 64)}


# K4-K7's tile: the shared memory it aims at; a column tile of short rows
# (N2 <= 2^SHORT_ROW_LOG) reads row segments of at least two sectors:
# 32-byte segments of such rows ran K4 at half speed.
ROUND_TILE_BYTES = 40 * 1024
SHORT_ROW_LOG = 6


def bank_row(word: int) -> int:
    """Words of one shared-memory bank row: 32 of 4 bytes or 16 of 8."""
    return 16 if word == 64 else 32


def round_smem(logn: int, tile_log: int, word: int) -> int:
    """Bytes of K4-K7's exchange buffer for 2^tile_log transforms of
    2^logn words (``round_smem`` in the source): each transform padded by
    one word a bank row (rounds.cuh's ``padded``), rounded up to whole bank
    rows, plus row / 2^tile_log words, which puts the transforms' words of
    one access in distinct banks."""
    n, row = 1 << logn, bank_row(word)
    pitch = -(-(n + (n - 1) // row) // row) * row + max(1, row >> tile_log)
    return pitch * (word // 8) << tile_log


def round_tile_log(n1_log: int, n2_log: int, word: int, rows: bool,
                   transposed: bool = False) -> int:
    """K4 / K7's tile (or with rows, K5 / K6's, storing or reading the
    (N2, N1) layout with transposed): log2 of its columns (TC) or rows
    (TR).  A tile's row segments (K4, K7), or the words of a column it
    moves together (K5 / K6 transposed), fill at least a sector (two on
    short rows); K5 / K6 in the (N1, N2) layout move whole rows and start
    from one.  The tile grows while its exchange buffer stays within
    ROUND_TILE_BYTES and shrinks only where shared memory forces it.  The launcher derives the
    rest of the geometry from it: 16 words a thread in rounds of 4 stages
    (fewer on a shorter transform), two groups a thread."""
    size = word // 8
    axis_log, other_log = (n2_log, n1_log) if rows else (n1_log, n2_log)
    if rows:
        segment = SECTOR_BYTES if transposed else size
    else:
        segment = SECTOR_BYTES * (2 if n2_log <= SHORT_ROW_LOG else 1)
    lg = min((segment // size).bit_length() - 1, other_log)
    while lg < other_log and round_smem(axis_log, lg + 1, word) <= ROUND_TILE_BYTES:
        lg += 1
    while lg > 0 and round_smem(axis_log, lg, word) > SMEM_BYTES:
        lg -= 1
    if round_smem(axis_log, lg, word) > SMEM_BYTES:
        raise ValueError(f"a {'row' if rows else 'column'} of 2^{axis_log} words of "
                         f"{word} bits exceeds one block's shared memory")
    return lg


def _logs(plan: NttPlan, n1_log: int) -> tuple[int, int]:
    if not 1 <= n1_log <= plan.m:
        raise ValueError(f"n1_log={n1_log} outside [1, {plan.m}] for N=2^{plan.m}")
    return n1_log, plan.m - n1_log


def _launch(kernel: str, a: torch.Tensor, plan: NttPlan, w: torch.Tensor,
            w_con: torch.Tensor, before: tuple, after: tuple) -> torch.Tensor:
    """Launch ``kernel`` at the plan's width into a new output, its Solinas
    instantiation where the switch takes q; its launcher takes (in, out, w,
    w_con, *before, batch, *after[, e, k], stream), w_con null for the
    Solinas one."""
    batch = cuda_batch(a, plan)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    sol = mm.solinas_args(plan.q, plan.word)
    name = native.entry(kernel, plan.word, sol)
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), w.data_ptr(),
                      None if sol else w_con.data_ptr(), *before, batch, *after,
                      *(sol or ()), native.stream(a.device))
    (SOLINAS_LAUNCHES if sol else LAUNCHES)[name] += 1
    return out


def _col_plan(plan: NttPlan, n1_log: int, col_plan: NttPlan | None) -> NttPlan:
    """The plan whose tables (and, inverse, n^-1 constants) the column
    stages read: ``plan`` itself, or a plan of N1 = 2^n1_log words at the
    same q, whose tables are ``plan``'s first N1 entries (the two-level
    six-step's level-1 plan, whose constants scale by 1/N1)."""
    if col_plan is None:
        return plan
    if col_plan.q != plan.q or col_plan.m != n1_log:
        raise ValueError(f"column plan (q={col_plan.q:#x}, m={col_plan.m}) does not match "
                         f"q={plan.q:#x}, n1_log={n1_log}")
    return col_plan


def fwd_cols(a: torch.Tensor, plan: NttPlan, n1_log: int,
             col_plan: NttPlan | None = None) -> torch.Tensor:
    """K4: forward column stages of (..., N) in the (N1, N2) layout; lazy
    output (< 4q) in the same layout.  With ``col_plan`` the stages read
    its tables (see ``_col_plan``): the same twiddles."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = _col_plan(plan, n1_log, col_plan).device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.fwd_cols(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q, n1_log)
    tc = round_tile_log(n1_log, n2_log, plan.word, rows=False)
    return _launch("fwd_cols", a, plan, tabs.w, tabs.w_con, (plan.q,), (n1_log, n2_log, tc))


def fwd_rows(a: torch.Tensor, plan: NttPlan, n1_log: int, strict: bool = True,
             keep_transposed: bool = False) -> torch.Tensor:
    """K5: forward row stages of fwd_cols' output; (N1, N2) layout out, or
    (N2, N1) with keep_transposed; < q with strict, else < 4q."""
    n1_log, n2_log = _logs(plan, n1_log)
    tabs = plan.device_tables(a.device)
    if native.route(a) == "cpu":
        return sixstep.fwd_rows(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q, n1_log,
                                strict, keep_transposed)
    tr = round_tile_log(n1_log, n2_log, plan.word, rows=True, transposed=keep_transposed)
    return _launch("fwd_rows", a, plan, tabs.w, tabs.w_con, (plan.q,),
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
    tr = round_tile_log(n1_log, n2_log, plan.word, rows=True, transposed=input_transposed)
    return _launch("inv_rows", a, plan, tabs.w_inv, tabs.w_inv_con, (plan.q,),
                   (n1_log, n2_log, tr, int(input_transposed)))


def inv_cols(a: torch.Tensor, plan: NttPlan, n1_log: int,
             col_plan: NttPlan | None = None) -> torch.Tensor:
    """K7: inverse column stages and the fused n^-1 stage of inv_rows'
    output; strict output in the standard order.  With ``col_plan`` the
    stages read its tables and n^-1 constants (``_col_plan``): the
    two-level six-step's level-1 inverse scales by 1/N1."""
    n1_log, n2_log = _logs(plan, n1_log)
    cols = _col_plan(plan, n1_log, col_plan)
    tabs = cols.device_tables(a.device)
    n_inv, n_inv_con, f_tmp, f_con = cols.inv_consts
    if native.route(a) == "cpu":
        return sixstep.inv_cols(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con, n_inv,
                                n_inv_con, f_tmp, f_con, plan.q, n1_log)
    tc = round_tile_log(n1_log, n2_log, plan.word, rows=False)
    mask = (1 << plan.word) - 1
    return _launch("inv_cols", a, plan, tabs.w_inv, tabs.w_inv_con,
                   (plan.q, n_inv, n_inv_con, f_tmp, f_con & mask, f_con >> plan.word),
                   (n1_log, n2_log, tc))
