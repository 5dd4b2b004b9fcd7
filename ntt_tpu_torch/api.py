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
from ntt_tpu_torch.kernels import fused, layouts, pointwise, rec, sixstep, twopass
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
    out = _pick(plan, variant, rows=x.numel() // plan.n).fwd(plan, x, lazy)
    return mm.to_host(out) if host else out


def inv_ntt(a, params_or_plan, variant: str = "auto", device="cuda"):
    """Inverse negacyclic NTT (strict output in [0, q))."""
    plan = _resolve(params_or_plan)
    x, host = _to_device(a, plan, device)
    out = _pick(plan, variant, inverse=True, rows=x.numel() // plan.n).inv(plan, x)
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

    # device ops (tensor -> tensor)
    def fwd(self, t: torch.Tensor) -> torch.Tensor:
        v, plan = self._variant, self.plan
        return self._tiled(lambda x: v.fwd(plan, x, self.lazy), self._check(t))

    def inv(self, t: torch.Tensor) -> torch.Tensor:
        v, plan = self._variant, self.plan
        return self._tiled(lambda x: v.inv(plan, x), self._check(t))

    def pointwise(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return pointwise.mul_mod(self._check(a), self._check(b), self.plan.q)

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
