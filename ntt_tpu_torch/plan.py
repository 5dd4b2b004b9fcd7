"""NttPlan: the twiddle tables of one (q, m) instance, on the host and on
each device that asks for them.

The counterpart of ``ntt_tpu/plan.py``: the bit-reversed root powers
``w`` / ``w_inv`` with their Shoup constants at word 64 (``w_con``,
``w_inv_con``) and word 32 (``w_con32``, ``w_inv_con32``), the n^-1
constants, the fused final stage's ``(f_tmp, f_con)``
(``ntt_tpu.kernels.radix2._final_mulop``), for the two-level six-step its
level plans and factored twist tables (``ntt_tpu.api._rec_level_plans``
/ ``_rec_twist_reps``), and the expanded tables of the reference's
variant families (``ntt_tpu/plan.py:68-190``; EXTRA_TABLES), each with
its constants at the words its variants compute at, and the 'mxu'
variant's limb matrices and twiddle / scale tables (MXU_TABLES).  Host tables are
numpy uint64 built by the port's ``twiddles``, each at first use; device
tables are int32 or int64 tensors, cached per device and width.
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
# The expanded tables, by name, with their length in units of N; the JAX
# plan has each under the same name (``w_r4_vec(False)`` / ``(True)`` for
# ``w_r4_vec`` / ``w_r4_vec_unord``).
EXTRA_TABLES = {
    **{k: 2 for k in ("w_r4", "w_r4_con", "w_r4_con32", "w_r4_con56", "w_inv_r4",
                      "w_inv_r4_con", "w_inv_r4_con32", "w_inv_r4_con56", "w_hexl",
                      "w_hexl_con")},
    "w_r2_16": 3, "w_r2_16_con": 3,
    **{k: 5 for k in ("w_r4_vec", "w_r4_vec_con", "w_r4_vec_unord", "w_r4_vec_unord_con",
                      "w_r4_vec_inv", "w_r4_vec_inv_con", "w_r4_vec_inv_unord",
                      "w_r4_vec_inv_unord_con", "w_r4r2", "w_r4r2_con")},
}
EXTRA_SCALARS = ("n_inv_con56",)
# The mxu variant's tables, forward and inverse: dicts with the JAX
# package's keys (``twiddles.mxu_tables``; ``get_mxu_tables`` /
# ``get_mxu_inv_tables`` in the JAX package, via ``kernels.mxu.tables_from_numpy``).
MXU_TABLES = {"mxu": ("m1", "w2", "t", "t_con"), "mxu_inv": ("w2i", "m1i", "s", "s_con")}


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
    caller never builds the inverse tables); ``table`` gives any host
    table at a chosen width."""

    def __init__(self, plan: "NttPlan", device: torch.device):
        self._plan, self._device = plan, device
        self._twist: dict[tuple[int, bool], tuple[torch.Tensor, ...]] = {}
        self._tables: dict[tuple[str, int], torch.Tensor] = {}
        self._mxu: dict[bool, dict] = {}

    def table(self, name: str, word: int) -> torch.Tensor:
        """Host table ``name`` on this device: int32 (its low 32 bits) at
        word 32, int64 at word 64 or 56, copied at first use."""
        key = (name, 32 if word == 32 else 64)
        if key not in self._tables:
            host = np.asarray(getattr(self._plan, name), dtype=np.uint64)
            rep = host.astype(np.uint32).view(np.int32) if word == 32 else host.view(np.int64)
            self._tables[key] = torch.from_numpy(rep.copy()).to(self._device)
        return self._tables[key]

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

    def mxu(self, inverse: bool) -> dict:
        """The plan's mxu tables (``NttPlan.mxu`` / ``mxu_inv``) on this
        device: limbs as int8 tensors, the (N1, N2) tables as int32 (their
        uint32 patterns), ``n1_log`` as it is."""
        if inverse not in self._mxu:
            host = self._plan.mxu_inv if inverse else self._plan.mxu
            self._mxu[inverse] = {
                k: v if k == "n1_log" else torch.from_numpy(np.ascontiguousarray(
                    v if v.dtype == np.int8 else v.astype(np.uint32).view(np.int32)
                )).to(self._device)
                for k, v in host.items()}
        return self._mxu[inverse]

    def twist(self, l1_log: int, inverse: bool) -> tuple[torch.Tensor, ...]:
        """(A, Ac, B, Bc) of ``NttPlan.twist_tables`` on this device."""
        key = (l1_log, inverse)
        if key not in self._twist:
            q = self._plan.q
            self._twist[key] = tuple(mm.from_host(t, q, self._device)
                                     for t in self._plan.twist_tables(l1_log, inverse))
        return self._twist[key]


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
        self._twist: dict[tuple[int, bool], tuple[np.ndarray, ...]] = {}

    @classmethod
    def from_numpy(cls, params: NttParams, tables: dict) -> "NttPlan":
        """A plan computing with given tables: ``tables`` maps every name in
        TABLE_NAMES to a numpy array of N entries (or an int for the
        ``n_inv_con*`` scalars), e.g. the attributes of a JAX
        ``ntt_tpu.plan.NttPlan`` of the same params; it may also hold the
        EXTRA_TABLES, EXTRA_SCALARS and the MXU_TABLES dicts
        (``kernels.mxu.tables_from_numpy``)."""
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
        for k, units in EXTRA_TABLES.items():
            if k in tables:
                arr = np.asarray(tables[k], dtype=np.uint64)
                if arr.shape != (units * params.n,):
                    raise ValueError(f"table {k} has shape {arr.shape}, want "
                                     f"({units * params.n},)")
                plan.__dict__[k] = arr
        for k in EXTRA_SCALARS:
            if k in tables:
                plan.__dict__[k] = int(tables[k])
        n1 = 1 << tw.mxu_split(params.n)
        n2 = params.n // n1
        shapes = {"m1": (4, n1, n1), "m1i": (4, n1, n1), "w2": (4, n2, n2),
                  "w2i": (4, n2, n2)}
        for k, keys in MXU_TABLES.items():
            if k in tables:
                got = dict(tables[k])
                bad = [t for t in keys if np.shape(got[t]) != shapes.get(t, (n1, n2))]
                if bad or got["n1_log"] != tw.mxu_split(params.n):
                    raise ValueError(f"{k}: tables {bad} or n1_log {got['n1_log']} are not "
                                     f"those of the split N1 = {n1}")
                plan.__dict__[k] = got
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

    @functools.cached_property
    def n_inv_con56(self) -> int:
        return tw.calc_ninv_con(self.params.n_inv, self.q, 56)

    # -- the expanded tables of the variant families (EXTRA_TABLES) --------
    def _con(self, name: str, word: int) -> np.ndarray:
        """calc_w_con of a table, computed up to its last nonzero entry
        (the 5N layouts fill about a third of their length; con(0) = 0),
        and for the 2N expand_w tables only on the odd slots: the even ones
        hold w (or w_inv) itself."""
        tab = getattr(self, name)
        out = np.zeros_like(tab)
        if name in ("w_r4", "w_inv_r4"):
            base = "w" if name == "w_r4" else "w_inv"
            out[0::2] = getattr(self, base + {64: "_con", 32: "_con32"}[word]) if word != 56 \
                else tw.calc_w_con(getattr(self, base), self.q, 56)
            out[1::2] = tw.calc_w_con(tab[1::2], self.q, word)
            return out
        end = len(tab) - int(np.argmax(tab[::-1] != 0)) if tab.any() else 0
        out[:end] = tw.calc_w_con(tab[:end], self.q, word)
        return out

    @functools.cached_property
    def w_r4(self) -> np.ndarray:
        return tw.expand_w(self.w, self.q)

    @functools.cached_property
    def w_inv_r4(self) -> np.ndarray:
        return tw.expand_w(self.w_inv, self.q)

    @functools.cached_property
    def w_r4_con(self) -> np.ndarray:
        return self._con("w_r4", 64)

    @functools.cached_property
    def w_inv_r4_con(self) -> np.ndarray:
        return self._con("w_inv_r4", 64)

    @functools.cached_property
    def w_r4_con32(self) -> np.ndarray:
        return self._con("w_r4", 32)

    @functools.cached_property
    def w_inv_r4_con32(self) -> np.ndarray:
        return self._con("w_inv_r4", 32)

    @functools.cached_property
    def w_r4_con56(self) -> np.ndarray:
        return self._con("w_r4", 56)

    @functools.cached_property
    def w_inv_r4_con56(self) -> np.ndarray:
        return self._con("w_inv_r4", 56)

    @functools.cached_property
    def w_hexl(self) -> np.ndarray:
        return tw.expand_w_hexl(self.w)

    @functools.cached_property
    def w_hexl_con(self) -> np.ndarray:
        """The layout of w_con: the layout only copies entries."""
        return tw.expand_w_hexl(self.w_con)

    @functools.cached_property
    def w_r2_16(self) -> np.ndarray:
        return tw.expand_w_r2_16(self.w)

    @functools.cached_property
    def w_r2_16_con(self) -> np.ndarray:
        return tw.expand_w_r2_16(self.w_con)

    @functools.cached_property
    def w_r4_vec(self) -> np.ndarray:
        return tw.expand_w_r4(self.w, self.q)

    @functools.cached_property
    def w_r4_vec_con(self) -> np.ndarray:
        return self._con("w_r4_vec", 64)

    @functools.cached_property
    def w_r4_vec_inv(self) -> np.ndarray:
        """The vector layout of the inverse root (the inverse of
        'radix4-vec' walks its regions backwards)."""
        return tw.expand_w_r4(self.w_inv, self.q)

    @functools.cached_property
    def w_r4_vec_inv_con(self) -> np.ndarray:
        return self._con("w_r4_vec_inv", 64)

    # the unordered tables (and their constants) permute the ordered ones'
    # FWD1 lanes: entry for entry the same values
    @functools.cached_property
    def w_r4_vec_unord(self) -> np.ndarray:
        return tw.unorder_r4(self.w_r4_vec, self.n)

    @functools.cached_property
    def w_r4_vec_unord_con(self) -> np.ndarray:
        return tw.unorder_r4(self.w_r4_vec_con, self.n)

    @functools.cached_property
    def w_r4_vec_inv_unord(self) -> np.ndarray:
        return tw.unorder_r4(self.w_r4_vec_inv, self.n)

    @functools.cached_property
    def w_r4_vec_inv_unord_con(self) -> np.ndarray:
        return tw.unorder_r4(self.w_r4_vec_inv_con, self.n)

    @functools.cached_property
    def w_r4r2(self) -> np.ndarray:
        return tw.expand_w_r4r2(self.w, self.q)

    @functools.cached_property
    def w_r4r2_con(self) -> np.ndarray:
        return self._con("w_r4r2", 64)

    # -- the mxu variant's tables (MXU_TABLES) --------------------------------
    @functools.cached_property
    def mxu(self) -> dict:
        return tw.mxu_tables(self.params.w, self.q, self.n)

    @functools.cached_property
    def mxu_inv(self) -> dict:
        return tw.mxu_tables(self.params.w, self.q, self.n, inverse=True)

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

    def rec_plans(self, l1_log: int) -> tuple["NttPlan", "NttPlan"]:
        """The level plans of the two-level six-step at N1 = 2^l1_log: size
        N1 with root w^N2 and size N2 with root w^N1.  Their tables are the
        global tables' prefixes; their n^-1 constants scale by 1/N1 and
        1/N2."""
        p = self.params
        n1, n2 = 1 << l1_log, 1 << (p.m - l1_log)
        return (get_plan(NttParams.make(p.q, l1_log, w=pow(p.w, n2, p.q))),
                get_plan(NttParams.make(p.q, p.m - l1_log, w=pow(p.w, n1, p.q))))

    def twist_tables(self, l1_log: int, inverse: bool) -> tuple[np.ndarray, ...]:
        """(A, Ac, B, Bc): ``twiddles.twist_tables_rec`` of w (or w_inv with
        inverse) at N1 = 2^l1_log, shapes (N1, HI) and (N1, LO), with their
        Shoup constants at the plan's word."""
        key = (l1_log, inverse)
        if key not in self._twist:
            psi = self.params.w_inv if inverse else self.params.w
            a, b = tw.twist_tables_rec(psi, self.q, self.n, l1_log)
            self._twist[key] = (a, tw.calc_w_con(a, self.q, self.word),
                                b, tw.calc_w_con(b, self.q, self.word))
        return self._twist[key]

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
