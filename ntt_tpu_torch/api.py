"""Public API: fwd_ntt / inv_ntt / pointwise_mul / negacyclic_mul over a
variant registry.

The counterpart of ``ntt_tpu/api.py``.  Inputs and outputs:

  * numpy arrays (uint64, any leading batch dims, last dim N) are moved to
    ``device`` (default ``"cuda"``), transformed there, and returned as
    numpy uint64;
  * tensors (int32 for q < 2^30, int64 otherwise, holding the unsigned
    patterns) are transformed where they lie and returned as tensors.

A CUDA tensor runs the CUDA kernels; a CPU tensor runs their plain
PyTorch versions.  Nothing picks the CPU because CUDA is missing: numpy
input with the default ``device="cuda"`` raises on a machine without a
card.

Variant ``"auto"`` resolves to ``"pallas-fused"`` wherever N fits one
block's shared memory (m <= 14 at word 64, m <= 15 at word 32) and to the
two-pass ``"sixstep"`` beyond, except at the (width, m, batch) cells of
``REC_CELLS``, where the two-level ``"sixstep-rec"`` was measured faster
on the card.  This is not the JAX package's measured ``_AUTO_TABLE``: at
m <= 8 the JAX forward ``"auto"`` picks ``"radix2"`` or ``"radix4-u32"``,
whose lazy outputs differ from the six-step's by contract, so lazy
outputs are compared per named variant.  Strict outputs
are the same for every variant.

The reference's variant families run under their JAX names on K9
``r2_stage`` / K10 ``r4_stage`` (``kernels/radix2.py``, ``radix4.py``,
``mixed.py``); ``"radix4x4"`` runs the register rounds of K1 / K2 and
K4-K7.  ``"radix4-vec-unordered"`` returns the forward in the layout of
``output_layout`` and its inverse reads it.

``"mxu"`` (q < 2^28) runs the four-step transform as two int8-limb
matrix products mod q on K11 ``limb_matmul`` (``kernels/mxu.py``), two
launches a transform; its output is always strict.  ``"auto"`` never
picks it, as in the JAX package.

``"sixstep-unordered"`` returns the forward in the transposed layout that
``output_layout`` describes, and its inverse reads that layout; the
layout's split is the JAX package's (``kernels.sixstep.word_split``), so
the permutation is the JAX package's too.  ``negacyclic_mul`` through
``"sixstep"`` (and ``"auto"`` beyond one block) keeps both forwards and the
product in that layout, as the JAX package's fused product does, unless
the caller passes ``fused=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import trace
from ntt_tpu_torch.kernels import (fused, layouts, mixed, mxu, pointwise, radix2, radix4, rec,
                                   sixstep, twopass)
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.params import NttParams
from ntt_tpu_torch.plan import NttPlan, get_plan


@dataclasses.dataclass(frozen=True)
class Variant:
    """Registry entry.  fwd(plan, tensor, lazy) and inv(plan, tensor) map a
    device rep to a device rep; max_m bounds m per word (32, 64), min_m
    from below.  A ``word64`` variant computes at Shoup word 64 (or 56)
    for every q, as its JAX namesake does: it takes the plan's rep or an
    int64 tensor (numpy input goes in as int64).  The reference-family
    variants' fwd and inv also take plain=True: their kernels' plain
    versions wherever the tensor lies (what the card's kernels are held
    against)."""

    name: str
    fwd: Callable
    inv: Callable | None
    max_q_bits: int = 62
    max_m: tuple[int, int] | None = None
    description: str = ""
    min_m: int = 1
    word64: bool = False


_REGISTRY: dict[str, Variant] = {}


def register(v: Variant) -> Variant:
    _REGISTRY[v.name] = v
    return v


def variants() -> dict[str, Variant]:
    return dict(_REGISTRY)


def get_variant(name: str) -> Variant:
    if name not in _REGISTRY:
        raise KeyError(f"unknown NTT variant {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


register(
    Variant(
        "pallas-fused",
        fwd=lambda plan, a, lazy: fused.fwd_fused(a, plan, strict=not lazy),
        inv=lambda plan, a: fused.inv_fused(a, plan),
        max_m=(fused.max_logn(32), fused.max_logn(64)),
        description="whole transform of a polynomial in one launch, held in "
        "shared memory through all log2 N stages (port of the Pallas fused "
        "kernels); N up to one block's shared memory",
    )
)


def _split(plan: NttPlan) -> int:
    return sixstep.word_split(plan.n, plan.word)


def _sixstep_fwd(plan: NttPlan, a, lazy: bool, keep_transposed: bool = False):
    n1_log = _split(plan)
    a = twopass.fwd_cols(a, plan, n1_log)
    return twopass.fwd_rows(a, plan, n1_log, strict=not lazy,
                            keep_transposed=keep_transposed)


def _sixstep_inv(plan: NttPlan, a, input_transposed: bool = False):
    n1_log = _split(plan)
    a = twopass.inv_rows(a, plan, n1_log, input_transposed=input_transposed)
    return twopass.inv_cols(a, plan, n1_log)


register(
    Variant(
        "sixstep",
        fwd=_sixstep_fwd,
        inv=_sixstep_inv,
        description="two-pass six-step N = N1 x N2: column pass, then row pass "
        "(forward); row pass, then column pass with the fused n^-1 stage "
        "(inverse); any N whose rows and columns fit a block",
    )
)

register(
    Variant(
        "sixstep-unordered",
        fwd=lambda plan, a, lazy: _sixstep_fwd(plan, a, lazy, keep_transposed=True),
        inv=lambda plan, a: _sixstep_inv(plan, a, input_transposed=True),
        description="six-step forward whose output stays in the transposed "
        "layout of output_layout(); the inverse reads that layout",
    )
)


register(
    Variant(
        "sixstep-rec",
        fwd=lambda plan, a, lazy: rec.fwd_rec(a, plan, strict=not lazy),
        inv=lambda plan, a: rec.inv_rec(a, plan),
        description="two-level six-step N = N1 x N2, N1 = 2^(m // 2): both "
        "levels full negacyclic NTTs (K4 on the columns, K1 / K2 on the rows), "
        "glued by the factored twist K8; m >= 2",
    )
)

# -- the reference's variant families (ntt_tpu/api.py:190-270, :741-752,
# :914-1115), on K9 / K10 (kernels/radix2.py, radix4.py, mixed.py) and, for
# 'radix4x4', on K1 / K2 and K4-K7 --------------------------------------------

# The word-64 radix-4 variants take q < 2^60, not the JAX package's 2^61: their
# dual Shoup product is below 2q only while t1 + t2 < 16q <= 2^64.  At a
# 61-bit q it can reach 3q, a butterfly's output then passes 2^64, and the
# strict forward is wrong for some inputs, in the JAX package as in its
# refmodel (tests/test_torch_variants.py, test_radix4_cap_below_2_61).
R4_MAX_Q_BITS = 60


def _at_word64(plan: NttPlan, a: torch.Tensor, fn, bound: int = 1) -> torch.Tensor:
    """fn (a word-64 transform) of ``a``: an int64 tensor as it is; the
    int32 rep of a q < 2^30 through an int64 working copy, narrowed back,
    where the output's bound (``bound`` * q) fits 32 bits."""
    if a.dtype == torch.int64:
        return fn(a)
    if bound * plan.q > 1 << 32:
        raise ValueError(f"the output reaches {bound}q > 2^32 for q = {plan.q:#x}: an int32 "
                         "tensor cannot hold it; pass an int64 tensor (or numpy input)")
    return fn(a.to(torch.int64) & mm.MASK32).to(torch.int32)


def _word64_variant(name: str, fwd, inv, lazy_bound=(4, 4), **kw) -> Variant:
    """A word64 Variant of fwd(plan, a, strict, plain) and inv(plan, a,
    plain); the lazy forward is below lazy_bound[m % 2] * q."""
    return register(Variant(
        name,
        fwd=lambda plan, a, lazy, plain=False: _at_word64(
            plan, a, lambda x: fwd(plan, x, not lazy, plain),
            lazy_bound[plan.m % 2] if lazy else 1),
        inv=lambda plan, a, plain=False: _at_word64(plan, a, lambda x: inv(plan, x, plain)),
        word64=True, **kw))


def _radix2_inv(plan: NttPlan, a, plain=False):
    return radix2.inv(a, plan, 64, plain)


_word64_variant(
    "radix2", lambda plan, a, strict, plain: radix2.fwd(a, plan, 64, strict, plain), _radix2_inv,
    description="radix-2 Harvey at word 64 (the reference's src/ntt_reference.c): one K9 "
    "launch a stage; lazy output < 4q")
register(Variant(
    "radix2-u32",
    fwd=lambda plan, a, lazy, plain=False: radix2.fwd(a, plan, 32, not lazy, plain),
    inv=lambda plan, a, plain=False: radix2.inv(a, plan, 32, plain),
    max_q_bits=mm.U32_PATH_MAX_Q_BITS_R2,
    description="radix-2 Harvey at word 32 on int32 reps (q < 2^30): one K9 launch a stage"))
_word64_variant(
    "radix4", lambda plan, a, strict, plain: radix4.fwd(a, plan, 64, strict, plain),
    lambda plan, a, plain: radix4.inv(a, plan, 64, plain), (8, 4), max_q_bits=R4_MAX_Q_BITS,
    description="radix-4 five-twiddle at word 64 (src/ntt_radix4.c): one K10 launch a "
    "radix-4 stage, a radix-2 sweep for odd log2 N; lazy output < 8q (even) / 4q (odd)")
register(Variant(
    "radix4-u32",
    fwd=lambda plan, a, lazy, plain=False: radix4.fwd(a, plan, 32, not lazy, plain),
    inv=lambda plan, a, plain=False: radix4.inv(a, plan, 32, plain),
    max_q_bits=mm.U32_PATH_MAX_Q_BITS_R4,
    description="radix-4 at word 32 on int32 reps (q < 2^28: the dual product needs "
    "16q <= 2^32): one K10 launch a stage"))
_word64_variant(
    "radix4-w56", lambda plan, a, strict, plain: radix4.fwd(a, plan, 56, strict, plain),
    lambda plan, a, plain: radix4.inv(a, plan, 56, plain), (8, 4),
    max_q_bits=mm.W56_PATH_MAX_Q_BITS,
    description="radix-4 at Shoup word 56, the s390x VMSL form "
    "(src/ntt_radix4_s390x_vef.c): quotients are bits 56.. of the 128-bit constant "
    "products; q < 2^52; K10 at word 56")


def _r4r2_word(plan: NttPlan) -> int:
    """The JAX dispatch: word 32 where q < 2^28, else word 64."""
    return 32 if plan.q < 1 << mm.U32_PATH_MAX_Q_BITS_R4 else 64


def _r4r2_fwd(plan: NttPlan, a, lazy: bool, plain: bool = False):
    if _r4r2_word(plan) == 32:
        return mixed.fwd(a, plan, 32, not lazy, plain)
    return _at_word64(plan, a, lambda x: mixed.fwd(x, plan, 64, not lazy, plain),
                      4 if lazy else 1)


def _r4r2_inv(plan: NttPlan, a, plain: bool = False):
    if _r4r2_word(plan) == 32:
        return mixed.inv(a, plan, 32, plain)
    return _at_word64(plan, a, lambda x: mixed.inv(x, plan, 64, plain))


register(Variant(
    "r4r2", fwd=_r4r2_fwd, inv=_r4r2_inv, max_q_bits=R4_MAX_Q_BITS,
    description="mixed radix (src/ntt_r4r2_avx512_ifma.c): radix-4 sweeps on K10, a "
    "radix-2 tail of 4 (even log2 N) or 3 stages on K9, over the 5N r4r2 layout at word "
    "64 from N = 128; word 32 where q < 2^28, word 64 beyond; lazy output < 4q"))
_word64_variant(
    "seal", lambda plan, a, strict, plain: radix2.fwd_seal(a, plan, strict, plain),
    lambda plan, a, plain: radix2.inv_seal(a, plan, plain),
    description="SEAL's radix-2 (third_party/seal/ntt_seal.c) at word 64: the forward's "
    "values are the Harvey chain's; the inverse keeps SEAL's final stage (guard "
    "placement, fused scaled_r, trailing 2q -> q sweep), a K9 mode of its own")


def _radix4x4_fwd(plan: NttPlan, a, lazy: bool, plain: bool = False):
    if plain:
        tabs = plan.device_tables(a.device)
        return sixstep.fwd_sixstep(a, pick_ops(plan.q), tabs.w, tabs.w_con, plan.q,
                                   strict=not lazy)
    if plan.m <= fused.max_logn(plan.word):
        return fused.fwd_fused(a, plan, strict=not lazy)
    return _sixstep_fwd(plan, a, lazy)


def _radix4x4_inv(plan: NttPlan, a, plain: bool = False):
    if plain:
        tabs = plan.device_tables(a.device)
        return sixstep.inv_sixstep(a, pick_ops(plan.q), tabs.w_inv, tabs.w_inv_con,
                                   *plan.inv_consts, plan.q)
    if plan.m <= fused.max_logn(plan.word):
        return fused.inv_fused(a, plan)
    return _sixstep_inv(plan, a)


register(Variant(
    "radix4x4", fwd=_radix4x4_fwd, inv=_radix4x4_inv,
    description="radix-16 blocks (src/ntt_radix4x4.c): four radix-2 layers a round in "
    "registers, the register rounds of K1 / K2 within one block and of K4-K7 beyond; "
    "the flat radix-2 bits, lazy included"))
_word64_variant(
    "radix4-vec", lambda plan, a, strict, plain: radix4.fwd_vec(a, plan, strict, False, plain),
    lambda plan, a, plain: radix4.inv_vec(a, plan, False, plain), (8, 8),
    max_q_bits=R4_MAX_Q_BITS, min_m=8,
    description="radix-4 over the 5N vector layout (src/ntt_radix4_avx512_ifma.c): a "
    "leading radix-2 stage for odd log2 N, quintuples from the FWD8 / FWD4 / FWD1 regions "
    "in emission order; the inverse walks the inverse root's regions backwards; K10, "
    "N >= 256; lazy output < 8q")
_word64_variant(
    "radix4-vec-unordered",
    lambda plan, a, strict, plain: radix4.fwd_vec(a, plan, strict, True, plain),
    lambda plan, a, plain: radix4.inv_vec(a, plan, True, plain), (8, 8),
    max_q_bits=R4_MAX_Q_BITS, min_m=8,
    description="radix4-vec whose last radix-4 stage takes its groups in the FWD1 "
    "region's LANE_PERM order and stores them in place "
    "(src/ntt_radix4_avx512_ifma_unordered.c): output in output_layout()'s order, which "
    "the inverse reads as it is")
_word64_variant(
    "hexl", lambda plan, a, strict, plain: radix2.fwd_layout(a, plan, "hexl", strict, plain),
    _radix2_inv, min_m=3,
    description="Intel HEXL's radix-2 (third_party/hexl/fwd-ntt-avx512.c): the forward "
    "reads the 13N/8 duplicated layout; inputs below 4q; the inverse is radix2's, as in "
    "the JAX package")
_word64_variant(
    "r2-16", lambda plan, a, strict, plain: radix2.fwd_layout(a, plan, "r2_16", strict, plain),
    _radix2_inv, min_m=4,
    description="radix-2 over the 3N r2_16 layout (src/ntt_r2_16_avx512_ifma.c), its tail "
    "segments read through their duplications and lane orders; the inverse is radix2's")


register(Variant(
    "mxu",
    fwd=lambda plan, a, lazy, plain=False: mxu.fwd_mxu(a, plan, plain),
    inv=lambda plan, a, plain=False: mxu.inv_mxu(a, plan, plain),
    max_q_bits=mxu.MAX_Q_BITS,
    description="four-step NTT as two int8-limb matrix products mod q on the tensor cores "
    "(K11 limb_matmul, the TPU's MXU form, ntt_tpu/kernels/mxu.py); always strict; "
    "q < 2^28"))


# The (width, m) cells where 'auto' takes 'sixstep-rec', with the range of
# batches (rows, both ends measured) it takes it at: where chip_smoke.py's
# rec-against-flat timing found it faster than the flat 'sixstep' by more
# than the spread between two passes, forward and inverse, in device time
# and in a stream of calls (NVIDIA H100 80GB HBM3, 700 W power limit;
# PERF.md section 5, run 34).
#   word 32, m17, batch 128 / 256 / 512: forward 179.5 / 338.1 / 652.3 us
#   against 198.6 / 383.9 / 746.1 in a stream, inverse 180.0 / 337.5 / 647.6
#   against 200.2 / 384.0 / 748.9; at batch 64 the flat forward wins.
# Nowhere else: at batch 1-8 rec's device time is often shorter, but its
# third launch makes the call host-bound and twice as long; from m18 at
# batch 8 up its extra pass costs more than it saves.
REC_CELLS: dict[tuple[int, int], tuple[int, int]] = {(32, 17): (128, 512)}


def output_layout(variant: str, params_or_plan) -> layouts.Layout:
    """Layout of a variant's forward output: ``layouts.standard`` unless the
    variant keeps another (``"sixstep-unordered"``: the transposed one)."""
    plan = _resolve(params_or_plan)
    if variant == "sixstep-unordered":
        return layouts.transposed(plan.n, _split(plan))
    if variant == "radix4-vec-unordered":
        return layouts.radix4_vec_unordered(plan.n)
    return layouts.standard(plan.n)


def _resolve(params_or_plan) -> NttPlan:
    if isinstance(params_or_plan, NttPlan):
        return params_or_plan
    if isinstance(params_or_plan, NttParams):
        return get_plan(params_or_plan)
    raise TypeError(type(params_or_plan))


def _pick(plan: NttPlan, variant: str, inverse: bool = False,
          rows: int | None = None) -> Variant:
    """The variant a call runs; ``"auto"`` with the call's batch (``rows``)
    takes ``"sixstep-rec"`` within a cell's range of REC_CELLS, and never
    without a batch."""
    if variant == "auto":
        lo, hi = REC_CELLS.get((plan.word, plan.m), (1, 0))
        if rows is not None and lo <= rows <= hi:
            variant = "sixstep-rec"
        elif plan.m <= fused.max_logn(plan.word):
            variant = "pallas-fused"
        else:
            variant = "sixstep"
    v = get_variant(variant)
    if inverse and v.inv is None:
        raise ValueError(f"variant {v.name} has no inverse kernel")
    if plan.q.bit_length() > v.max_q_bits:
        raise ValueError(
            f"variant {v.name} supports q < 2^{v.max_q_bits}, got "
            f"{plan.q.bit_length()}-bit q"
        )
    if plan.m < v.min_m:
        raise ValueError(f"variant {v.name} needs m >= {v.min_m}, got m={plan.m}")
    if v.max_m is not None:
        cap = v.max_m[0] if plan.word == 32 else v.max_m[1]
        if plan.m > cap:
            raise ValueError(
                f"variant {v.name} serves m <= {cap} at word {plan.word}, got "
                f"m={plan.m}; the two-pass 'sixstep' variant serves larger N"
            )
    return v


def _to_device(a, plan: NttPlan, device, word64: bool = False):
    """(device rep, came_from_host) for a numpy array or a tensor; with
    word64 an int64 tensor is taken for any q, and numpy goes in as one."""
    if isinstance(a, torch.Tensor):
        if a.dtype != plan.dtype and not (word64 and a.dtype == torch.int64):
            raise TypeError(f"expected {plan.dtype} for q={plan.q:#x}, got {a.dtype}")
        t, host = a.contiguous(), False
    else:
        t, host = mm.from_host(a, plan.q, device, wide=word64), True
    if t.dim() < 1 or t.shape[-1] != plan.n:
        raise ValueError(f"last dim must be N={plan.n}, got shape {tuple(t.shape)}")
    return t, host


def _rows(a, plan: NttPlan) -> int:
    """The batch of an input: its size over N."""
    return int(np.prod(np.shape(a))) // plan.n


def _same_kind(a, b):
    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        raise TypeError("pass both operands as tensors or both as numpy arrays")


def fwd_ntt(a, params_or_plan, variant: str = "auto", lazy: bool = False,
            device="cuda"):
    """Forward negacyclic NTT of values in [0, q): natural order in,
    bit-reversed out; strict output in [0, q), or with lazy the variant's
    lazy representatives (< 4q for pallas-fused)."""
    plan = _resolve(params_or_plan)
    v = _pick(plan, variant, rows=_rows(a, plan))
    x, host = _to_device(a, plan, device, v.word64)
    out = v.fwd(plan, x, lazy)
    return mm.to_host(out) if host else out


def inv_ntt(a, params_or_plan, variant: str = "auto", device="cuda"):
    """Inverse negacyclic NTT (strict output in [0, q))."""
    plan = _resolve(params_or_plan)
    v = _pick(plan, variant, inverse=True, rows=_rows(a, plan))
    x, host = _to_device(a, plan, device, v.word64)
    out = v.inv(plan, x)
    return mm.to_host(out) if host else out


def fwd_ntt_dbl(a, b, params_or_plan, variant: str = "auto", lazy: bool = False,
                device="cuda"):
    """Transform two polynomials in one call (the reference's ``_dbl``
    variants); arbitrary batches go through fwd_ntt's leading dims."""
    _same_kind(a, b)
    if isinstance(a, torch.Tensor):
        both = torch.stack([a, b])
    else:
        both = np.stack([np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)])
    out = fwd_ntt(both, params_or_plan, variant, lazy, device)
    return out[0], out[1]


def pointwise_mul(a, b, params_or_plan, device="cuda"):
    """Element-wise (a * b) mod q for values in [0, q): the NTT-domain
    product step of a negacyclic polynomial multiply."""
    plan = _resolve(params_or_plan)
    _same_kind(a, b)
    x, host = _to_device(a, plan, device)
    y, _ = _to_device(b, plan, device)
    out = pointwise.mul_mod(x, y, plan.q)
    return mm.to_host(out) if host else out


def negacyclic_mul(a, b, params_or_plan, variant: str = "auto", fused: bool = True,
                   device="cuda"):
    """Polynomial product in R_q[X]/(X^N + 1): forward NTT of both operands,
    pointwise product, inverse NTT, all on the device; strict output.

    With fused (the default, as in the JAX package) and variant ``"auto"``
    or ``"sixstep"``, the product runs as one pipeline: through the
    six-step the operands stay in the transposed layout from the forwards
    to the inverse.  Any other variant (``"sixstep-rec"`` too, as in the
    JAX package), or fused=False, composes fwd_ntt, pointwise_mul and
    inv_ntt through that variant (``"auto"`` resolved as fwd_ntt resolves
    it).  The bits are the same either way."""
    plan = _resolve(params_or_plan)
    _same_kind(a, b)
    x, host = _to_device(a, plan, device)
    y, _ = _to_device(b, plan, device)
    if variant not in ("auto", "sixstep"):
        fused = False
    v = _pick(plan, variant, inverse=True, rows=x.numel() // plan.n)
    if fused and v.name == "sixstep":
        v = get_variant("sixstep-unordered")
    out = v.inv(plan, pointwise.mul_mod(v.fwd(plan, x, False), v.fwd(plan, y, False),
                                        plan.q))
    return mm.to_host(out) if host else out


class DeviceNtt:
    """Device-resident transform handle for serving pipelines (the
    reference's ``api.DeviceNtt``): the plan's tables are put on ``device``
    once, and ``fwd``, ``inv``, ``pointwise`` and ``negacyclic`` map
    tensors on that device to tensors there, so that a chain of products
    never leaves the card.  Tensors are the plan's int32 / int64 reps, last
    dim N, any leading batch dims.

    >>> ctx = DeviceNtt(params)
    >>> fa, fb = ctx.fwd(ctx.from_host(a)), ctx.fwd(ctx.from_host(b))
    >>> c = ctx.to_host(ctx.inv(ctx.pointwise(fa, fb)))

    It runs the reference handle's bits: pallas-fused (K1 / K2) within one
    block and the two-pass six-step beyond, never the two-level form, so
    its lazy forward gives the reference handle's representatives (< 4q).
    ``negacyclic`` keeps the six-step's transposed layout between its
    forwards and its inverse, as ``negacyclic_mul`` does; its pointwise
    product takes the forwards' lazy output as it is (K3 reduces any
    product of two words below 4q fully).

    batch_tile: an int runs a batch of more rows than the tile in tiles of
    that many rows (``negacyclic`` chains forwards, product and inverse a
    tile), a batch that is not a multiple of the tile directly unless
    pad_to_tile, which pads zero rows to the next multiple once and slices
    them off once; None and ``"auto"`` never tile (the reference's
    ``"auto"`` policy describes a TPU's on-chip memory; no H100 measurement
    has earned one).  tile_mode (``"unroll"`` or ``"map"``, XLA program
    forms in the reference) is accepted and changes no bit: tiles run one
    after another either way.  The tiles give the same bits as one call.
    """

    def __init__(self, params_or_plan, lazy: bool = False,
                 batch_tile: "int | str | None" = "auto", pad_to_tile: bool = False,
                 tile_mode: str = "unroll", device="cuda"):
        if tile_mode not in ("unroll", "map"):
            raise ValueError(f"tile_mode must be 'unroll' or 'map', got {tile_mode!r}")
        if not (batch_tile in (None, "auto") or (isinstance(batch_tile, int)
                                                 and batch_tile > 0)):
            raise ValueError(f"batch_tile must be a positive int, None or 'auto', "
                             f"got {batch_tile!r}")
        self.plan = _resolve(params_or_plan)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but torch.cuda.is_available() "
                               "is false; pass device='cpu' to run the plain PyTorch path")
        self.lazy = lazy
        self._tile = batch_tile if isinstance(batch_tile, int) else None
        self._pad_to_tile = pad_to_tile
        self.tile_mode = tile_mode
        self._variant = _pick(self.plan, "auto", inverse=True)
        tabs = self.plan.device_tables(self.device)
        self.tables = (tabs.w, tabs.w_con, tabs.w_inv, tabs.w_inv_con)

    # host <-> device
    def from_host(self, a) -> torch.Tensor:
        return mm.from_host(a, self.plan.q, self.device)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        return mm.to_host(t)

    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"DeviceNtt takes tensors (from_host), got {type(t).__name__}")
        if t.device.type != self.device.type:
            raise ValueError(f"tensor on {t.device}, handle on {self.device}")
        return _to_device(t, self.plan, self.device)[0]

    def _tiled(self, fn, *ts: torch.Tensor) -> torch.Tensor:
        """fn over row tiles of ts (the batch_tile / pad_to_tile rules), or
        over ts whole."""
        tile = self._tile
        batch = ts[0].shape[0] if ts[0].dim() >= 2 else 0
        if not tile or batch <= tile:
            return fn(*ts)
        pad = -batch % tile
        if pad and not self._pad_to_tile:
            return fn(*ts)
        if pad:
            ts = tuple(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) for t in ts)
        out = torch.cat([fn(*(t[i:i + tile] for t in ts))
                         for i in range(0, batch + pad, tile)])
        return out[:batch] if pad else out

    # device ops (tensor -> tensor), each call an op span (trace.py)
    @trace.traced("op")
    def fwd(self, t: torch.Tensor) -> torch.Tensor:
        v, plan = self._variant, self.plan
        return self._tiled(lambda x: v.fwd(plan, x, self.lazy), self._check(t))

    @trace.traced("op")
    def inv(self, t: torch.Tensor) -> torch.Tensor:
        v, plan = self._variant, self.plan
        return self._tiled(lambda x: v.inv(plan, x), self._check(t))

    @trace.traced("op")
    def pointwise(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return pointwise.mul_mod(self._check(a), self._check(b), self.plan.q)

    @trace.traced("op")
    def negacyclic(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The full product: both forwards, the pointwise product and the
        inverse, a tile at a time where the handle tiles; strict output."""
        v, plan = self._variant, self.plan
        if v.name == "sixstep":
            v = get_variant("sixstep-unordered")

        def chain(x, y):
            return v.inv(plan, pointwise.mul_mod(v.fwd(plan, x, self.lazy),
                                                 v.fwd(plan, y, self.lazy), plan.q))

        return self._tiled(chain, self._check(a), self._check(b))
