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
two-pass ``"sixstep"`` beyond.  This is not the JAX package's measured
``_AUTO_TABLE``: at m <= 8 the JAX forward ``"auto"`` picks ``"radix2"``
or ``"radix4-u32"``, whose lazy outputs differ from the six-step's by
contract, so lazy outputs are compared per named variant.  Strict outputs
are the same for every variant.

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
from ntt_tpu_torch.kernels import fused, layouts, pointwise, sixstep, twopass
from ntt_tpu_torch.params import NttParams
from ntt_tpu_torch.plan import NttPlan, get_plan


@dataclasses.dataclass(frozen=True)
class Variant:
    """Registry entry.  fwd(plan, tensor, lazy) and inv(plan, tensor) map a
    device rep to a device rep; max_m bounds m per word (32, 64)."""

    name: str
    fwd: Callable
    inv: Callable | None
    max_q_bits: int = 62
    max_m: tuple[int, int] | None = None
    description: str = ""


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


def output_layout(variant: str, params_or_plan) -> layouts.Layout:
    """Layout of a variant's forward output: ``layouts.standard`` unless the
    variant keeps another (``"sixstep-unordered"``: the transposed one)."""
    plan = _resolve(params_or_plan)
    if variant == "sixstep-unordered":
        return layouts.transposed(plan.n, _split(plan))
    return layouts.standard(plan.n)


def _resolve(params_or_plan) -> NttPlan:
    if isinstance(params_or_plan, NttPlan):
        return params_or_plan
    if isinstance(params_or_plan, NttParams):
        return get_plan(params_or_plan)
    raise TypeError(type(params_or_plan))


def _pick(plan: NttPlan, variant: str, inverse: bool = False) -> Variant:
    if variant == "auto":
        fits = plan.m <= fused.max_logn(plan.word)
        variant = "pallas-fused" if fits else "sixstep"
    v = get_variant(variant)
    if inverse and v.inv is None:
        raise ValueError(f"variant {v.name} has no inverse kernel")
    if plan.q.bit_length() > v.max_q_bits:
        raise ValueError(
            f"variant {v.name} supports q < 2^{v.max_q_bits}, got "
            f"{plan.q.bit_length()}-bit q"
        )
    if v.max_m is not None:
        cap = v.max_m[0] if plan.word == 32 else v.max_m[1]
        if plan.m > cap:
            raise ValueError(
                f"variant {v.name} serves m <= {cap} at word {plan.word}, got "
                f"m={plan.m}; the two-pass 'sixstep' variant serves larger N"
            )
    return v


def _to_device(a, plan: NttPlan, device):
    """(device rep, came_from_host) for a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype != plan.dtype:
            raise TypeError(f"expected {plan.dtype} for q={plan.q:#x}, got {a.dtype}")
        t, host = a.contiguous(), False
    else:
        t, host = mm.from_host(a, plan.q, device), True
    if t.dim() < 1 or t.shape[-1] != plan.n:
        raise ValueError(f"last dim must be N={plan.n}, got shape {tuple(t.shape)}")
    return t, host


def _same_kind(a, b):
    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        raise TypeError("pass both operands as tensors or both as numpy arrays")


def fwd_ntt(a, params_or_plan, variant: str = "auto", lazy: bool = False,
            device="cuda"):
    """Forward negacyclic NTT of values in [0, q): natural order in,
    bit-reversed out; strict output in [0, q), or with lazy the variant's
    lazy representatives (< 4q for pallas-fused)."""
    plan = _resolve(params_or_plan)
    x, host = _to_device(a, plan, device)
    out = _pick(plan, variant).fwd(plan, x, lazy)
    return mm.to_host(out) if host else out


def inv_ntt(a, params_or_plan, variant: str = "auto", device="cuda"):
    """Inverse negacyclic NTT (strict output in [0, q))."""
    plan = _resolve(params_or_plan)
    x, host = _to_device(a, plan, device)
    out = _pick(plan, variant, inverse=True).inv(plan, x)
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
    to the inverse.  Any other variant, or fused=False, composes fwd_ntt,
    pointwise_mul and inv_ntt through that variant (``"auto"`` resolved as
    fwd_ntt resolves it).  The bits are the same either way."""
    plan = _resolve(params_or_plan)
    _same_kind(a, b)
    if variant not in ("auto", "sixstep"):
        fused = False
    v = _pick(plan, variant, inverse=True)
    if fused and v.name == "sixstep":
        v = get_variant("sixstep-unordered")
    x, host = _to_device(a, plan, device)
    y, _ = _to_device(b, plan, device)
    out = v.inv(plan, pointwise.mul_mod(v.fwd(plan, x, False), v.fwd(plan, y, False),
                                        plan.q))
    return mm.to_host(out) if host else out
