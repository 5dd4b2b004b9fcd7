"""Cost probes of the fused forward transform: CUDA kernels L3, their plain
PyTorch versions and their wrappers.

The counterpart of the Pallas lab's diagnostic kernels
(``tools/pallas_lab.py``: ``diag_copy`` :444, ``diag_mul`` :402,
``diag_math`` :455, ``diag_moves`` :479, all through ``_diag_call`` :419).
Each probe runs one part of K1's work (``kernels/fused.py``) at K1's design
point (``csrc/rounds.cuh``'s ``Fused<T>``: 512 threads at most, 16 words a
thread taken by K1's first-round load at stride N/16), so that their
times split K1's:

  * ``diag_copy``: the identity, on K1's memory path alone (K1's shared
    memory and occupancy): K1's first-round load into registers, one
    barrier and its coalesced store, no rounds;
  * ``diag_math``: ``n_rounds`` Harvey butterflies of coefficient i with
    i + N/2 under stage 0's twiddle w[1], on ``diag_copy``'s path: at
    n_rounds = m, K1's butterfly count without its twiddle loads or
    exchanges;
  * ``diag_moves``: K1 itself with each butterfly replaced by a swap of its
    pair (the movement-only policy ``Swaps``): K1's load, exchanges,
    barriers and store without arithmetic or twiddle loads.  Each stage
    flips one bit of the index, so the result is the polynomial reversed;
  * ``diag_mul``: every 32-bit half of every word takes ``x*c + 1 mod 2^32``
    42 times (c = 0x9E3779B1, as the Pallas probe), the thread's 16 / 32
    halves one step at a time, stored from registers, with no shared
    memory: 32-bit multiply throughput.

At the same shape ``diag_copy`` is K1's memory path, ``diag_math -
diag_copy`` what its butterflies add, ``diag_moves - diag_copy`` its
exchanges and barriers, and the rest of K1 what its twiddle loads add
(``lab.k1_split``).  Every probe takes N up to ``fused.max_logn``, as K1,
on either route.

The Pallas probes take a batch that is a multiple of their tile; these take
any batch.  A wrapper runs the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA device, with no fallback; ``LAUNCHES`` counts
the kernel launches per probe and width.  The design is in
``csrc/probes.cu``.

Under the NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``, read at every
call), at a q of the Solinas form of the plan's word, ``diag_math``'s
butterflies take the Solinas product, as the Pallas probe's do: its wrapper
launches the SolinasRed instantiation, which reads no w_con, and counts it
in ``SOLINAS_LAUNCHES``; ``plain_math`` follows the same switch.  The other
probes do no mod-q product.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.kernels.fused import max_logn
from ntt_tpu_torch.plan import NttPlan

MUL_C = 0x9E3779B1
N_MULTS = 42

LAUNCHES = {f"diag_{k}_u{w}": 0 for k in ("copy", "mul", "math", "moves") for w in (32, 64)}
SOLINAS_LAUNCHES = {f"diag_math_solinas_u{w}": 0 for w in (32, 64)}


def _word(a: torch.Tensor) -> int:
    if a.dtype == torch.int32:
        return 32
    if a.dtype == torch.int64:
        return 64
    raise TypeError(f"expected an int32 or int64 tensor, got {a.dtype}")


def _logn(a: torch.Tensor) -> int:
    """log2 N of a's polynomials, N within one block's shared memory (K1's
    limit) at a's width."""
    n = a.shape[-1] if a.dim() else 0
    if n < 2 or n & (n - 1):
        raise ValueError(f"last dim must be a power of two >= 2, got shape {tuple(a.shape)}")
    logn, word = n.bit_length() - 1, _word(a)
    if logn > max_logn(word):
        raise ValueError(f"N=2^{logn} at word {word} exceeds one block's shared memory")
    return logn


def _launch(probe: str, a: torch.Tensor, *args, solinas=None) -> torch.Tensor:
    """Launch probe ``probe`` at a's width: (in, out, *args, batch, logn,
    stream), its Solinas instantiation with (e, k) before the stream where
    ``solinas`` is set."""
    word, logn = _word(a), _logn(a)
    if not a.is_contiguous():
        raise ValueError("the probes take a contiguous tensor")
    out = torch.empty_like(a)
    batch = a.numel() >> logn
    if batch == 0:
        return out
    name = native.entry(f"diag_{probe}", word, solinas)
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), out.data_ptr(), *args, batch, logn,
                      *(solinas or ()), native.stream(a.device))
    (SOLINAS_LAUNCHES if solinas else LAUNCHES)[name] += 1
    return out


def plain_mul(a: torch.Tensor, n_mults: int = N_MULTS) -> torch.Tensor:
    if _word(a) == 32:
        c = mm.s32(MUL_C)
        for _ in range(n_mults):
            a = a * c + 1  # int32 arithmetic wraps mod 2^32
        return a
    lo, hi = a & mm.MASK32, mm.shr64(a, 32)
    for _ in range(n_mults):
        lo = (lo * MUL_C + 1) & mm.MASK32
        hi = (hi * MUL_C + 1) & mm.MASK32
    return (hi << 32) | lo


def plain_math(a: torch.Tensor, plan: NttPlan, n_rounds: int) -> torch.Tensor:
    tabs = plan.device_tables(a.device)
    ops = pick_ops(plan.q)
    half = a.shape[-1] // 2
    x, y = a[..., :half], a[..., half:]
    for _ in range(n_rounds):
        x, y = ops.fwd_bfly(x, y, tabs.w[1], tabs.w_con[1], plan.q)
    return torch.cat([x, y], dim=-1)


def diag_copy(a: torch.Tensor) -> torch.Tensor:
    """Each polynomial as it is, through K1's load and store."""
    _logn(a)
    if native.route(a) == "cpu":
        return a.clone()
    return _launch("copy", a)


def diag_mul(a: torch.Tensor, n_mults: int = N_MULTS) -> torch.Tensor:
    """``x*c + 1 mod 2^32``, n_mults times (the Pallas probe's N_MULTS
    unless a timing asks for more), on each 32-bit half of each word."""
    _logn(a)
    if native.route(a) == "cpu":
        return plain_mul(a, n_mults)
    return _launch("mul", a, MUL_C, n_mults)


def diag_math(a: torch.Tensor, plan: NttPlan, n_rounds: int) -> torch.Tensor:
    """n_rounds forward butterflies of (a[i], a[i + N/2]) under w[1]; a of
    the plan's dtype, any N (the plan gives q and the twiddle)."""
    _logn(a)
    if a.dtype != plan.dtype:
        raise TypeError(f"expected {plan.dtype} for q={plan.q:#x}, got {a.dtype}")
    if native.route(a) == "cpu":
        return plain_math(a, plan, n_rounds)
    tabs = plan.device_tables(a.device)
    sol = mm.solinas_args(plan.q, plan.word)
    return _launch("math", a, tabs.w.data_ptr(), None if sol else tabs.w_con.data_ptr(),
                   plan.q, n_rounds, solinas=sol)


def diag_moves(a: torch.Tensor) -> torch.Tensor:
    """K1 with swaps for butterflies: each polynomial reversed."""
    _logn(a)
    if native.route(a) == "cpu":
        return a.flip(-1)
    return _launch("moves", a)
