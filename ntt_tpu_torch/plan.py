"""NttPlan: the twiddle tables of one (q, m) instance, on the host and on
each device that asks for them.

The counterpart of ``ntt_tpu/plan.py``, cut to the tables the fused
transform reads: the bit-reversed root powers ``w`` / ``w_inv`` with
their Shoup constants at word 64 (``w_con``, ``w_inv_con``) and word 32
(``w_con32``, ``w_inv_con32``), the n^-1 constants, and the fused final
stage's ``(f_tmp, f_con)`` (``ntt_tpu.kernels.radix2._final_mulop``).
Host tables are numpy uint64 built by the port's ``twiddles``; device
tables are int32 or int64 tensors of the plan's width, cached per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import twiddles as tw
from ntt_tpu_torch.params import NttParams

ARRAY_TABLES = ("w", "w_con", "w_inv", "w_inv_con", "w_con32", "w_inv_con32")
SCALAR_TABLES = ("n_inv_con", "n_inv_con32")
TABLE_NAMES = ARRAY_TABLES + SCALAR_TABLES


def final_mulop(n_inv_op: int, n_inv_con: int, w1: int, q: int, word: int):
    """(tmp, con) of the fused final inverse stage: tmp = n_inv * w_inv[1]
    (lazy, < 2q) and its Shoup constant, which may be one bit wider than
    the word (``ntt_tpu.kernels.radix2._final_mulop``)."""
    beta = 1 << word
    big_q = (n_inv_con * w1) >> word
    tmp = (n_inv_op * w1 - big_q * q) % beta
    return tmp, (tmp << word) // q


class DeviceTables:
    """The plan's tables at its width, as tensors on one device: w, w_con,
    w_inv, w_inv_con, each built and copied at first use (a forward-only
    caller never builds the inverse tables)."""

    def __init__(self, plan: "NttPlan", device: torch.device):
        self._plan, self._device = plan, device

    def _load(self, name: str) -> torch.Tensor:
        host = name + "32" if self._plan.word == 32 and name.endswith("_con") else name
        return mm.from_host(getattr(self._plan, host), self._plan.q, self._device)

    @functools.cached_property
    def w(self) -> torch.Tensor:
        return self._load("w")

    @functools.cached_property
    def w_con(self) -> torch.Tensor:
        return self._load("w_con")

    @functools.cached_property
    def w_inv(self) -> torch.Tensor:
        return self._load("w_inv")

    @functools.cached_property
    def w_inv_con(self) -> torch.Tensor:
        return self._load("w_inv_con")


class NttPlan:
    """All tables of one (q, m) instance."""

    def __init__(self, params: NttParams):
        self.params = params
        self.q = params.q
        self.n = params.n
        self.m = params.m
        self.word = 32 if mm.uses_u32(self.q) else 64
        self.dtype = mm.dtype_for(self.q)
        self._dev: dict[torch.device, DeviceTables] = {}

    @classmethod
    def from_numpy(cls, params: NttParams, tables: dict) -> "NttPlan":
        """A plan computing with given tables: ``tables`` maps every name in
        TABLE_NAMES to a numpy array of N entries (or an int for the
        ``n_inv_con*`` scalars), e.g. the attributes of a JAX
        ``ntt_tpu.plan.NttPlan`` of the same params."""
        missing = [k for k in TABLE_NAMES if k not in tables]
        if missing:
            raise KeyError(f"tables lack {missing}")
        plan = cls(params)
        for k in ARRAY_TABLES:
            arr = np.asarray(tables[k], dtype=np.uint64)
            if arr.shape != (params.n,):
                raise ValueError(f"table {k} has shape {arr.shape}, want ({params.n},)")
            plan.__dict__[k] = arr  # takes the place of the cached_property
        for k in SCALAR_TABLES:
            plan.__dict__[k] = int(tables[k])
        return plan

    # -- host tables (uint64 numpy), built on first use ---------------------
    @functools.cached_property
    def w(self) -> np.ndarray:
        return tw.calc_w(self.params.w, self.n, self.q)

    @functools.cached_property
    def w_inv(self) -> np.ndarray:
        return tw.calc_w_inv(self.params.w_inv, self.n, self.q)

    @functools.cached_property
    def w_con(self) -> np.ndarray:
        return tw.calc_w_con(self.w, self.q, 64)

    @functools.cached_property
    def w_inv_con(self) -> np.ndarray:
        return tw.calc_w_con(self.w_inv, self.q, 64)

    @functools.cached_property
    def w_con32(self) -> np.ndarray:
        return tw.calc_w_con(self.w, self.q, 32)

    @functools.cached_property
    def w_inv_con32(self) -> np.ndarray:
        return tw.calc_w_con(self.w_inv, self.q, 32)

    @functools.cached_property
    def n_inv_con(self) -> int:
        return tw.calc_ninv_con(self.params.n_inv, self.q, 64)

    @functools.cached_property
    def n_inv_con32(self) -> int:
        return tw.calc_ninv_con(self.params.n_inv, self.q, 32)

    def host_tables(self) -> dict:
        """Every table by name (the ``from_numpy`` format)."""
        return {k: getattr(self, k) for k in TABLE_NAMES}

    @functools.cached_property
    def inv_consts(self) -> tuple[int, int, int, int]:
        """(n_inv, n_inv_con, f_tmp, f_con) at the plan's word."""
        n_inv = self.params.n_inv
        n_inv_con = self.n_inv_con32 if self.word == 32 else self.n_inv_con
        f_tmp, f_con = final_mulop(n_inv, n_inv_con, int(self.w_inv[1]), self.q,
                                   self.word)
        return n_inv, n_inv_con, f_tmp, f_con

    def device_tables(self, device) -> DeviceTables:
        """w, w_con, w_inv, w_inv_con at the plan's width on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._dev:
            self._dev[device] = DeviceTables(self, device)
        return self._dev[device]


@functools.lru_cache(maxsize=64)
def get_plan(params: NttParams) -> NttPlan:
    return NttPlan(params)
