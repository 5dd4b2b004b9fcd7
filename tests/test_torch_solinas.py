"""The NTT_MULMOD=solinas switch in the port, on the CPU: the Solinas
products (``ntt_tpu_torch.modmath.mul_mod_q2_solinas`` /
``mul_mod32_q2_solinas``), ``solinas_form`` / ``solinas_form32``,
``params.find_solinas_ntt_prime`` and ``bench_params(solinas=True)`` against
the JAX package; the two folds of ``csrc/modarith.cuh`` compiled for the host
with g++ and called through ctypes on the same operands; one transform of
each JAX kernel the switch reaches, lazy representatives included, against
the JAX package run once in a subprocess under NTT_MULMOD=solinas; and
port-only checks at more sizes.

The switch is flipped in this process only through the port's global
(``modmath.USE_SOLINAS``, with monkeypatch): NTT_MULMOD is never set in this
process's environment, which later subprocesses inherit."""

import contextlib
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntt_tpu import modmath as jmm
from ntt_tpu import params as jparams
from ntt_tpu import refmodel as rm
from ntt_tpu_torch import api, lab, native
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import params as tparams
from ntt_tpu_torch.kernels import (fused, fused_lab, pointwise, probes, radix2, radix4, rec,
                                   twopass)
from ntt_tpu_torch.params import FIXTURES, NttParams, bench_params, find_solinas_ntt_prime
from ntt_tpu_torch.plan import get_plan

REPO = pathlib.Path(__file__).resolve().parents[1]
Q62 = (1 << 62) - (1 << 16) + 1  # the headline, bench_params(14, 62)
Q61 = (1 << 61) - (1 << 26) + 1  # serves m <= 25
Q60 = (1 << 60) - (1 << 18) + 1  # the radix-4 family's, m <= 17
Q51 = (1 << 51) - (1 << 17) + 1  # FIXTURES[12]'s q
Q29 = (1 << 29) - (1 << 9) + 1  # word 32, m <= 8
Q27 = (1 << 27) - (1 << 11) + 1  # word 32, m <= 10

# ----------------------------------------------------------------------------
# solinas_form / solinas_form32
# ----------------------------------------------------------------------------

FORM_QS = [
    Q62, Q61, Q60, Q51, Q29, Q27,
    (1 << 33) - (1 << 1) + 1,  # e = 33, the least e of the word-64 form
    (1 << 33) - (1 << 15) + 1,  # 2k + 3 == e
    (1 << 33) - (1 << 16) + 1,  # 2k + 3 > e
    (1 << 62) - (1 << 29) + 1,  # e = 62, 2k + 3 = 61
    (1 << 62) - (1 << 46) + 1,  # bench_params(16, 62, solinas=True): not of the form
    (1 << 63) - (1 << 16) + 1,  # e = 63
    (1 << 32) - (1 << 5) + 1,  # e = 32: neither form
    (1 << 29) - (1 << 13) + 1,  # word 32, 2k + 3 == e
    (1 << 30) - (1 << 9) + 1,  # e = 30: beyond the word-32 form
    FIXTURES[9].q,  # 0x1ffc8001: not of the form
    0x10001,
]


@pytest.mark.parametrize("q", FORM_QS, ids=hex)
def test_solinas_forms_equal_jax(q):
    assert mm.solinas_form(q) == jmm.solinas_form(q)
    assert mm.solinas_form32(q) == jmm.solinas_form32(q)


# ----------------------------------------------------------------------------
# the products: the port's plain ones and modarith.cuh's, against the JAX
# package's (no switch needed) and Python integers
# ----------------------------------------------------------------------------

# (q, t bound in units of q, word): t < 4q at e = 62 (the radix-2 bound),
# t < 8q at e <= 61 and at word 32
PRODUCT_CASES = [(Q62, 4, 64), (Q61, 8, 64), (Q60, 8, 64), (Q51, 8, 64), (Q29, 8, 32),
                 (Q27, 8, 32)]


def operands(q: int, t_bound: int, n: int = 4000):
    """tools/solinas_tpu_check.py's operand set: random w < q, t < t_bound,
    and the extremes of both ranges."""
    rng = np.random.default_rng(q % 1000)
    w = rng.integers(0, q, size=n, dtype=np.uint64)
    t = rng.integers(0, t_bound, size=n, dtype=np.uint64)
    we = np.array([0, 1, q - 1, q - 2, 1, q - 1], dtype=np.uint64)
    te = np.array([0, t_bound - 1, t_bound - 1, 1, t_bound - 2, 0], dtype=np.uint64)
    return np.concatenate([we, w]), np.concatenate([te, t])


def jax_product(w, t, q, word):
    if word == 64:
        e, k = jmm.solinas_form(q)
        return jmm.to_u64(jmm.mul_mod_q2_solinas(jmm.from_u64(w), jmm.from_u64(t), q, e, k))
    e, k = jmm.solinas_form32(q)
    return np.asarray(jmm.mul_mod32_q2_solinas(w.astype(np.uint32), t.astype(np.uint32), q,
                                               e, k)).astype(np.uint64)


def port_product(w, t, q, word):
    e, k = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
    if word == 64:
        out = mm.mul_mod_q2_solinas(torch.from_numpy(w.view(np.int64)),
                                    torch.from_numpy(t.view(np.int64)), q, e, k)
    else:
        out = mm.mul_mod32_q2_solinas(torch.from_numpy(w.astype(np.uint32).view(np.int32)),
                                      torch.from_numpy(t.astype(np.uint32).view(np.int32)),
                                      q, e, k)
    return mm.to_host(out)


@pytest.fixture(scope="module")
def jax_products():
    out = {}
    for q, mult, word in PRODUCT_CASES:
        w, t = operands(q, mult * q)
        out[q] = (w, t, jax_product(w, t, q, word))
    return out


@pytest.mark.parametrize("q,mult,word", PRODUCT_CASES, ids=lambda c: hex(c) if c > 64 else c)
def test_plain_product_equals_jax(jax_products, q, mult, word):
    w, t, want = jax_products[q]
    got = port_product(w, t, q, word)
    np.testing.assert_array_equal(got, want)
    assert (got < 2 * np.uint64(q)).all()
    assert all(int(g) % q == int(a) * int(b) % q for g, a, b in zip(got, w, t))


@pytest.fixture(scope="module")
def host_folds(tmp_path_factory):
    """csrc/modarith.cuh's two Solinas products, ``SolinasRed::mul`` on a
    policy built from (e, k) as the kernels build it, compiled for the host
    with g++ into a temporary shared library, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ not found: the host check of csrc/modarith.cuh needs it")
    tmp = tmp_path_factory.mktemp("modarith")
    src = tmp / "folds.cpp"
    src.write_text(
        '#include "modarith.cuh"\n'
        '#define FOLDS(T, NAME) extern "C" void NAME(const T* w, const T* t, T* out, long n, '
        "int e, int k) { const ntt::SolinasRed red{e, k}; for (long i = 0; i < n; ++i) "
        "out[i] = red.mul(w[i], T(0), t[i], T(0)); }\n"
        "FOLDS(ntt::u64, folds64)\nFOLDS(ntt::u32, folds32)\n")
    lib = tmp / "libfolds.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(native.CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    cdll = ctypes.CDLL(str(lib))
    for fn in (cdll.folds64, cdll.folds32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int, ctypes.c_int]
        fn.restype = None
    return cdll


@pytest.mark.parametrize("q,mult,word", PRODUCT_CASES, ids=lambda c: hex(c) if c > 64 else c)
def test_device_folds_equal_jax(host_folds, jax_products, q, mult, word):
    """The arithmetic of the CUDA source, held against the JAX package
    before any chip run."""
    w, t, want = jax_products[q]
    dt = np.uint64 if word == 64 else np.uint32
    wa, ta = np.ascontiguousarray(w.astype(dt)), np.ascontiguousarray(t.astype(dt))
    out = np.zeros_like(wa)
    e, k = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
    fn = host_folds.folds64 if word == 64 else host_folds.folds32
    fn(wa.ctypes.data, ta.ctypes.data, out.ctypes.data, len(wa), e, k)
    np.testing.assert_array_equal(out.astype(np.uint64), want)


def full_range_operands(q: int, word: int, n: int = 512):
    """n pairs w, t uniform over the whole word, and every pair of the edges
    0 and 2^word - 1."""
    rng = np.random.default_rng(q % 997)
    top = (1 << word) - 1
    w, t = rng.integers(0, top, size=(2, n), dtype=np.uint64, endpoint=True)
    edges = np.array([0, top], dtype=np.uint64)
    return np.concatenate([np.repeat(edges, 2), w]), np.concatenate([np.tile(edges, 2), t])


# the least e of each form with 2k + 3 == e, where r >> e outgrows 32 bits
# over the whole word, so A2's truncation shows
EDGE_FORMS = [((1 << 33) - (1 << 15) + 1, 64), ((1 << 29) - (1 << 13) + 1, 32)]


@pytest.mark.parametrize("q,word", [(q, word) for q, _, word in PRODUCT_CASES] + EDGE_FORMS,
                         ids=lambda c: hex(c) if c > 64 else c)
def test_device_folds_equal_jax_full_range(host_folds, q, word):
    """Beyond the lazy range the folds keep JAX's truncations (A to the
    word, A2 to 32 bits, the result mod 2^word), so modarith.cuh's products
    and the port's plain ones equal JAX's limb code on any operands."""
    w, t = full_range_operands(q, word)
    want = jax_product(w, t, q, word)
    dt = np.uint64 if word == 64 else np.uint32
    wa, ta = np.ascontiguousarray(w.astype(dt)), np.ascontiguousarray(t.astype(dt))
    out = np.zeros_like(wa)
    e, k = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
    fn = host_folds.folds64 if word == 64 else host_folds.folds32
    fn(wa.ctypes.data, ta.ctypes.data, out.ctypes.data, len(wa), e, k)
    np.testing.assert_array_equal(out.astype(np.uint64), want)
    np.testing.assert_array_equal(port_product(w, t, q, word), want)


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

PRIME_GRID = [(bits, m) for bits in (62, 61, 60, 29, 27) for m in (4, 10, 16, 19)]


@pytest.mark.parametrize("bits,m", PRIME_GRID, ids=lambda v: str(v))
def test_find_solinas_prime_and_bench_params_equal_jax(bits, m):
    """Both packages give the same q, or both raise; bench_params(solinas=
    True) the same params.  At (62, 16) that q, 2^62 - 2^46 + 1, is not of
    the form the switch takes."""
    try:
        want = jparams.find_solinas_ntt_prime(bits, m)
    except ValueError:
        with pytest.raises(ValueError):
            find_solinas_ntt_prime(bits, m)
        return
    assert find_solinas_ntt_prime(bits, m) == want
    jp, p = jparams.bench_params(m, bits, solinas=True), bench_params(m, bits, solinas=True)
    assert (p.q, p.m, p.w, p.w_inv, p.n_inv) == (jp.q, jp.m, jp.w, jp.w_inv, jp.n_inv)
    if (bits, m) == (62, 16):
        assert p.q == (1 << 62) - (1 << 46) + 1 and mm.solinas_form(p.q) is None


# ----------------------------------------------------------------------------
# whole transforms against the JAX package under the switch
# ----------------------------------------------------------------------------

# (variant, q bits, m, what): one call for each JAX kernel the switch
# reaches, the q the first of find_solinas_ntt_prime's at that width.  A1 at
# word 64 and A2's two-launch word-64 form (A3 + A4) run Pallas in interpret
# mode; A2 at word 32; the sixstep forward (B2, B3) and inverse; sixstep-rec
# (B5); the radix-2 family (C1) as radix2, SEAL's inverse, HEXL's layout and
# radix2-u32; the radix-4 family (C2) at q < 2^60 and at word 32; r4r2 (C3);
# mxu (C4, strict); the pointwise product (B4, strict).
JAX_CALLS = [
    ("pallas-fused", 62, 5, "lazy"), ("pallas-fused", 62, 5, "inv"),
    ("pallas-fused", 27, 8, "inv"),
    ("sixstep", 61, 6, "lazy"), ("sixstep", 61, 6, "inv"),
    ("sixstep-rec", 62, 6, "lazy"),
    ("radix2", 62, 5, "lazy"), ("seal", 62, 5, "inv"), ("hexl", 62, 5, "lazy"),
    ("radix2-u32", 29, 6, "lazy"),
    ("radix4", 60, 4, "lazy"), ("radix4", 60, 5, "inv"),
    ("radix4-u32", 27, 6, "lazy"), ("radix4-u32", 27, 5, "inv"),
    ("r4r2", 27, 7, "lazy"), ("r4r2", 27, 6, "inv"),
    ("mxu", 27, 6, "fwd"), ("mxu", 27, 6, "inv"),
    ("pointwise", 62, 5, "mul"),
]

# The JAX lab's kernels (tools/pallas_lab.py) under the switch, in interpret
# mode at m6 batch 8, on inputs below 4q from a numpy seed, at the Solinas-form
# q of each word: find_solinas_ntt_prime(62, 6) = 2^62 - 2^16 + 1 and (27, 6)
# = 2^27 - 2^11 + 1.  (kind, q bits, n1_log, group or rounds, strict,
# keep_transposed): L1 both groups, strict and lazy, at each word (n1_log 3
# leaves a radix-2 tail round); L2 strict, lazy and kept transposed at each
# word; diag_math (2 rounds at word 64, 6 at word 32).
LAB_M, LAB_BATCH = 6, 8
LAB_CALLS = [
    ("v2", 62, 3, 1, True, False), ("v2", 62, 2, 2, False, True),
    ("v2", 27, 2, 1, False, False), ("v2", 27, 3, 2, True, False),
    ("v3", 62, 3, 0, True, False), ("v3", 62, 2, 0, False, True),
    ("v3", 27, 2, 0, False, False), ("v3", 27, 3, 0, True, True),
    ("math", 62, 3, 2, True, False), ("math", 27, 3, 6, True, False),
]

# Runs in a subprocess whose environment has NTT_MULMOD=solinas: the JAX
# package reads the switch at import.  Its calls compile in a few threads.
_JAX_SCRIPT = r"""
import functools, importlib.util, json, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas as pl
from ntt_tpu import api, modmath, params
from ntt_tpu.kernels import elems
from ntt_tpu.plan import get_plan
assert modmath.USE_SOLINAS
calls, path, lab_calls = json.loads(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
lab_m, lab_batch = int(sys.argv[4]), int(sys.argv[5])
spec = importlib.util.spec_from_file_location("pallas_lab", "tools/pallas_lab.py")
jlab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jlab)
# the lab's probes (_diag_call) take no interpret flag
pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)

def run_lab(call):
    kind, bits, n1_log, arg, strict, keep_t = call
    p = params.NttParams.make(params.find_solinas_ntt_prime(bits, lab_m), lab_m)
    plan = get_plan(p)
    ops = elems.U32Ops if p.q < 1 << 30 else elems.U64Ops
    a = np.random.default_rng(bits).integers(0, 4 * p.q, size=(lab_batch, p.n),
                                             dtype=np.uint64)
    rep, n1, n2 = ops.from_host(a), 1 << n1_log, p.n >> n1_log
    tabs = plan.pallas_tables(False, n1_log, ops.nlimb)
    if kind == "v2":
        out = jlab.fwd_fused_v2(rep, ops, tabs, p.q, n1_log, group=arg, strict=strict,
                                keep_transposed=keep_t, interpret=True)
    elif kind == "v3":
        wc = plan.w_con32 if ops is elems.U32Ops else plan.w_con
        out = jlab.fwd_fused_v3(rep, ops, jlab.build_tables_v3(plan.w, wc, n1, n2, ops.nlimb),
                                p.q, n1_log, strict=strict, keep_transposed=keep_t,
                                interpret=True)
    else:
        out = jlab.diag_math(rep, ops, tabs, p.q, arg, n1, n2, lab_batch)
    return np.asarray(ops.to_host(out))

def run(call):
    name, bits, m, what = call
    p = params.NttParams.make(params.find_solinas_ntt_prime(bits, m), m)
    rng = np.random.default_rng(100 * bits + m)
    a = rng.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
    if what == "mul":
        b = rng.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
        return np.asarray(api.pointwise_mul(a, b, p))
    if what == "inv":
        return np.asarray(api.inv_ntt(a, p, name))
    return np.asarray(api.fwd_ntt(a, p, name, lazy=what == "lazy"))

# one pool for both lists, the lab's interpret-mode calls submitted first
jobs = [(run_lab, c, len(calls) + i) for i, c in enumerate(lab_calls)]
jobs += [(run, c, i) for i, c in enumerate(calls)]
outs = [None] * len(jobs)
with ThreadPoolExecutor(4) as ex:
    for (fn, c, i), out in zip(jobs, ex.map(lambda j: j[0](j[1]), jobs)):
        outs[i] = out
np.savez(path, *outs)
"""


def call_id(c):
    return "-".join(map(str, c))


@pytest.fixture(scope="module")
def jax_switched(tmp_path_factory):
    """The JAX package's outputs of JAX_CALLS and the JAX lab's of
    LAB_CALLS under NTT_MULMOD=solinas."""
    path = tmp_path_factory.mktemp("solinas") / "jax.npz"
    env = dict(os.environ, NTT_MULMOD="solinas", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("NTT_MULHI64", None)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(JAX_CALLS), str(path),
                        json.dumps(LAB_CALLS), str(LAB_M), str(LAB_BATCH)],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    data = np.load(path)
    return {tuple(c): data[f"arr_{i}"] for i, c in enumerate(JAX_CALLS + LAB_CALLS)}


def port_call(call):
    """The same call through the port's API (plain versions, CPU)."""
    name, bits, m, what = call
    p = NttParams.make(find_solinas_ntt_prime(bits, m), m)
    rng = np.random.default_rng(100 * bits + m)
    a = rng.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
    if what == "mul":
        b = rng.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
        return api.pointwise_mul(a, b, p, device="cpu")
    if what == "inv":
        return api.inv_ntt(a, p, name, device="cpu")
    return api.fwd_ntt(a, p, name, lazy=what == "lazy", device="cpu")


@pytest.mark.parametrize("call", JAX_CALLS, ids=call_id)
def test_transform_equals_jax_under_switch(jax_switched, monkeypatch, call):
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    np.testing.assert_array_equal(port_call(call), jax_switched[call])


def lab_call_id(c):
    kind, bits, n1_log, arg, strict, keep_t = c
    what = {"v2": f"L1-group{arg}", "v3": "L2", "math": f"diag_math-{arg}rounds"}[kind]
    if kind != "math":
        what += f"-{'strict' if strict else 'lazy'}{'-keep_t' if keep_t else ''}-n1_log{n1_log}"
    return f"q{bits}-{what}"


@pytest.mark.parametrize("call", LAB_CALLS, ids=lab_call_id)
def test_lab_kernel_equals_jax_lab_under_switch(jax_switched, monkeypatch, call):
    """L1, L2 and diag_math on the CPU route (their plain versions, which
    the kernels equal on the card) against the JAX lab under the switch,
    lazy representatives included."""
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    kind, bits, n1_log, arg, strict, keep_t = call
    p = NttParams.make(find_solinas_ntt_prime(bits, LAB_M), LAB_M)
    plan = get_plan(p)
    assert p.q == {62: Q62, 27: Q27}[bits] and mm.solinas_args(p.q, plan.word) is not None
    a = np.random.default_rng(bits).integers(0, 4 * p.q, size=(LAB_BATCH, p.n),
                                             dtype=np.uint64)
    x = mm.from_host(a, p.q, "cpu")
    if kind == "v2":
        got = fused_lab.fwd_fused_v2(x, plan, n1_log, arg, strict, keep_t)
    elif kind == "v3":
        got = fused_lab.fwd_fused_v3(x, plan, n1_log, strict, keep_t)
    else:
        got = probes.diag_math(x, plan, arg)
    np.testing.assert_array_equal(mm.to_host(got), jax_switched[call])


# ----------------------------------------------------------------------------
# port-only checks at more sizes: no JAX call
# ----------------------------------------------------------------------------


def lazy_bound(name: str, m: int) -> int:
    if name in ("radix4", "radix4-w56", "radix4-u32"):
        return 8 if m % 2 == 0 else 4
    return 8 if name.startswith("radix4-vec") else 4


def variant_q(v) -> int:
    """The widest Solinas-form q of the variant's width."""
    if v.max_q_bits >= 62:
        return Q61
    if v.max_q_bits >= 60:
        return Q60
    if v.max_q_bits >= 52:
        return Q51
    return Q29 if v.max_q_bits >= 30 else Q27


def variant_cases():
    for name, v in sorted(api.variants().items()):
        q = variant_q(v)
        last = 8 if q == Q29 else 10 if q == Q27 else 11
        for m in sorted({max(v.min_m, 2), max(v.min_m, 7), last}):
            yield name, q, m


@pytest.mark.parametrize("name,q,m", list(variant_cases()),
                         ids=lambda v: hex(v) if isinstance(v, int) and v > 64 else str(v))
def test_every_variant_strict_equals_refmodel_under_switch(monkeypatch, name, q, m):
    """Strict outputs are unique, so the switched forward equals refmodel's
    (Shoup, numpy); the lazy one stays below the variant's bound and equals
    the strict one mod q; the inverse gives the input back."""
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    p = NttParams.make(q, m)
    plan = get_plan(p)
    a = np.random.default_rng(m).integers(0, q, size=(2, p.n), dtype=np.uint64)
    strict = api.fwd_ntt(a, p, name, device="cpu")
    lazy = api.fwd_ntt(a, p, name, lazy=True, device="cpu")
    perm = api.output_layout(name, p).perm
    np.testing.assert_array_equal(strict[..., perm], rm.fwd_ntt_harvey(a, q, plan.w, plan.w_con))
    assert int(lazy.max()) < lazy_bound(name, m) * q
    np.testing.assert_array_equal(lazy % np.uint64(q), strict)
    np.testing.assert_array_equal(api.inv_ntt(strict, p, name, device="cpu"), a)


NON_SOLINAS = [(bench_params(16, 62, solinas=True).q, 9), (FIXTURES[9].q, 9),
               (tparams.find_ntt_prime(61, 10), 10)]


@pytest.mark.parametrize("q,m", NON_SOLINAS, ids=lambda v: hex(v) if v > 64 else str(v))
def test_non_solinas_q_keeps_shoup_bits_under_switch(monkeypatch, q, m):
    """A q the switch does not take computes the Shoup bits, lazy
    representatives included, in every variant."""
    p = NttParams.make(q, m)
    a = np.random.default_rng(3).integers(0, q, size=(2, p.n), dtype=np.uint64)
    names = [n for n, v in api.variants().items() if q.bit_length() <= v.max_q_bits]
    off = {n: api.fwd_ntt(a, p, n, lazy=True, device="cpu") for n in names}
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    assert mm.solinas_args(q, 64) is None and mm.solinas_args(q, 32) is None
    for n in names:
        np.testing.assert_array_equal(api.fwd_ntt(a, p, n, lazy=True, device="cpu"), off[n])


def test_word56_keeps_shoup_bits_under_switch(monkeypatch):
    """radix4-w56 at FIXTURES[12]'s q, of the word-64 Solinas form: word 56
    never takes the switch."""
    p = NttParams.make(Q51, 8)
    a = np.random.default_rng(4).integers(0, Q51, size=(2, p.n), dtype=np.uint64)
    off = api.fwd_ntt(a, p, "radix4-w56", lazy=True, device="cpu")
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    assert mm.solinas_args(Q51, 56) is None and mm.solinas_args(Q51, 64) == (51, 17)
    np.testing.assert_array_equal(api.fwd_ntt(a, p, "radix4-w56", lazy=True, device="cpu"),
                                  off)


@pytest.mark.parametrize("q,m,name", [(Q62, 9, "pallas-fused"), (Q27, 8, "radix2")],
                         ids=lambda v: hex(v) if isinstance(v, int) and v > 64 else str(v))
def test_switch_off_changes_nothing(q, m, name):
    """With the switch off (the default here) no q takes the Solinas
    product: the lazy forward at word 64 is refmodel's Shoup chain."""
    assert not mm.USE_SOLINAS and mm.solinas_args(q, 64) is None and mm.solinas_args(q, 32) is None
    p = NttParams.make(q, m)
    plan = get_plan(p)
    a = np.random.default_rng(5).integers(0, q, size=(2, p.n), dtype=np.uint64)
    np.testing.assert_array_equal(api.fwd_ntt(a, p, name, lazy=True, device="cpu"),
                                  rm.fwd_ntt_harvey_lazy(a, q, plan.w, plan.w_con))


# ----------------------------------------------------------------------------
# which instantiation the wrappers launch, and what raises
# ----------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Route CPU tensors to the wrappers' kernel branch and record each
    launch: its name, and its arguments checked against the entry point's
    ctypes signature (native.SIGNATURES)."""
    launched = []

    def launch(name, *args):
        assert len(args) == len(native.SIGNATURES["ntt_" + name]), name
        launched.append((name, args))

    monkeypatch.setattr(native, "route", lambda t: "cuda")
    monkeypatch.setattr(native, "launch", launch)
    monkeypatch.setattr(native, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return launched


def _drive_every_wrapper(q: int, m: int, word: int):
    p = NttParams.make(q, m)
    plan = get_plan(p)
    x = mm.from_host(np.zeros((1, p.n), dtype=np.uint64), q, "cpu", wide=word == 64)
    n1 = m // 2
    fused.fwd_fused(x, plan)
    fused.inv_fused(x, plan)
    twopass.fwd_cols(x, plan, n1)
    twopass.fwd_rows(x, plan, n1)
    twopass.inv_rows(x, plan, n1)
    twopass.inv_cols(x, plan, n1)
    rec.twist_mul(x, plan, n1)
    tabs = plan.device_tables("cpu")
    consts = radix2.consts_at(plan, word)
    radix2.r2_stage(x, tabs.table("w", word), tabs.table(radix2.con_name("w", word), word),
                    radix2.R2Stage(lt=0), q, word, consts)
    radix4.r4_stage(x, tabs.table("w_r4", word), tabs.table(radix2.con_name("w_r4", word), word),
                    radix4.R4Stage(lt=0), q, word, consts)


KERNELS = ("fwd_fused", "inv_fused", "fwd_cols", "fwd_rows", "inv_rows", "inv_cols",
           "twist_mul", "r2_stage", "r4_stage")


@pytest.mark.parametrize("q,word", [(Q61, 64), (Q27, 32)], ids=hex)
def test_wrappers_launch_the_solinas_instantiation(fake_card, monkeypatch, q, word):
    """Under the switch every wrapper launches its Solinas entry point with
    (e, k) and no Shoup-constant table (K10 keeps its con for the dual
    products), and counts it in SOLINAS_LAUNCHES; with the switch off the
    Shoup entry points, counted in LAUNCHES."""
    counts = (fused, twopass, rec, radix2, radix4)
    m = 6
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    before = {k: v for c in counts for k, v in c.SOLINAS_LAUNCHES.items()}
    shoup_before = {k: v for c in counts for k, v in c.LAUNCHES.items()}
    _drive_every_wrapper(q, m, word)
    form = mm.solinas_args(q, word)
    names = [n for n, _ in fake_card]
    assert names == [f"{k}_solinas_u{word}" for k in KERNELS]
    for name, args in fake_card:
        assert args[-3:-1] == form, name
        if not name.startswith("r4_stage"):
            assert None in args, name  # the w_con pointer (twist: Ac, Bc)
    for c in counts:
        for k, v in c.SOLINAS_LAUNCHES.items():
            assert v == before[k] + (k in names), k
        assert all(v == shoup_before[k] for k, v in c.LAUNCHES.items())
    fake_card.clear()
    monkeypatch.setattr(mm, "USE_SOLINAS", False)
    _drive_every_wrapper(q, m, word)
    assert [n for n, _ in fake_card] == [f"{k}_u{word}" for k in KERNELS]
    assert all(None not in args for _, args in fake_card)


@pytest.mark.parametrize("q,mult,word", PRODUCT_CASES, ids=lambda c: hex(c) if c > 64 else c)
def test_solinas_mul_check_wrapper(host_folds, fake_card, q, mult, word):
    """pointwise.solinas_mul, the check of the product alone: on CPU tensors
    its plain version equals modarith.cuh's folds over the whole word, switch
    off; on the card's route one launch of solinas_mul_u<word> with (e, k),
    counted in CHECK_LAUNCHES."""
    w, t = full_range_operands(q, word, n=64)
    dt, tdt = (np.uint64, np.int64) if word == 64 else (np.uint32, np.int32)
    wa, ta = np.ascontiguousarray(w.astype(dt)), np.ascontiguousarray(t.astype(dt))
    want = np.zeros_like(wa)
    form = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
    (host_folds.folds64 if word == 64 else host_folds.folds32)(
        wa.ctypes.data, ta.ctypes.data, want.ctypes.data, len(wa), *form)
    wt, tt = torch.from_numpy(wa.view(tdt)), torch.from_numpy(ta.view(tdt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "route", lambda x: "cpu")
        got = pointwise.solinas_mul(wt, tt, q)
    assert got.dtype == wt.dtype and torch.equal(got, torch.from_numpy(want.view(tdt)))
    before = dict(pointwise.CHECK_LAUNCHES)
    pointwise.solinas_mul(wt, tt, q)
    name = f"solinas_mul_u{word}"
    assert [n for n, _ in fake_card] == [name] and fake_card[0][1][-3:-1] == form
    assert pointwise.CHECK_LAUNCHES == {k: v + (k == name) for k, v in before.items()}
    with pytest.raises(ValueError, match="Solinas form"):
        pointwise.solinas_mul(wt, tt, FIXTURES[9].q if word == 32 else bench_params(16, 62).q)


def test_word56_launches_shoup_under_switch(fake_card, monkeypatch):
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    p = NttParams.make(Q51, 6)
    plan = get_plan(p)
    x = mm.from_host(np.zeros((1, p.n), dtype=np.uint64), Q51, "cpu")
    tabs = plan.device_tables("cpu")
    radix4.r4_stage(x, tabs.table("w_r4", 56), tabs.table(radix2.con_name("w_r4", 56), 56),
                    radix4.R4Stage(lt=0), Q51, 56, radix2.consts_at(plan, 56))
    assert [n for n, _ in fake_card] == ["r4_stage_w56"]


def _drive_lab_wrappers(q: int, m: int = 6):
    p = NttParams.make(q, m)
    plan = get_plan(p)
    x = mm.from_host(np.zeros((1, p.n), dtype=np.uint64), q, "cpu")
    fused_lab.fwd_fused_v2(x, plan, 3, group=1)
    fused_lab.fwd_fused_v2(x, plan, 3, group=2)
    fused_lab.fwd_fused_v3(x, plan, 3)
    probes.diag_math(x, plan, 2)
    return plan.word


LAB_KERNELS = ("fwd_fused_v2", "fwd_fused_v2", "fwd_fused_v3", "diag_math")
LAB_COUNTS = ("fwd_fused_v2_r2", "fwd_fused_v2_r4", "fwd_fused_v3", "diag_math")


@pytest.mark.parametrize("q,other", [(Q62, bench_params(16, 62, solinas=True).q),
                                     (Q27, FIXTURES[9].q)], ids=hex)
def test_lab_wrappers_launch_the_solinas_instantiation(fake_card, monkeypatch, q, other):
    """Under the switch L1 (both groups), L2 and diag_math launch their
    Solinas entry points with (e, k) and no w_con, counted in
    SOLINAS_LAUNCHES; off the switch, and at a q of the word not of the
    form, the Shoup ones, counted in LAUNCHES."""
    counts = (fused_lab, probes)

    def snapshot():
        return ({k: v for c in counts for k, v in c.SOLINAS_LAUNCHES.items()},
                {k: v for c in counts for k, v in c.LAUNCHES.items()})

    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    sol0, shoup0 = snapshot()
    word = _drive_lab_wrappers(q)
    form = mm.solinas_args(q, word)
    assert form is not None
    assert [n for n, _ in fake_card] == [f"{k}_solinas_u{word}" for k in LAB_KERNELS]
    for name, args in fake_card:
        assert args[-3:-1] == form and args[3] is None, name  # (e, k); no w_con pointer
    sol1, shoup1 = snapshot()
    assert sol1 == {k: v + (k in {f"{c}_solinas_u{word}" for c in LAB_COUNTS})
                    for k, v in sol0.items()}
    assert shoup1 == shoup0
    for on, at in ((False, q), (True, other)):
        fake_card.clear()
        monkeypatch.setattr(mm, "USE_SOLINAS", on)
        assert _drive_lab_wrappers(at) == word and mm.solinas_args(at, word) is None
        assert [n for n, _ in fake_card] == [f"{k}_u{word}" for k in LAB_KERNELS]
        assert all(None not in args for _, args in fake_card)
    sol2, shoup2 = snapshot()
    assert sol2 == sol1
    assert shoup2 == {k: v + 2 * (k in {f"{c}_u{word}" for c in LAB_COUNTS})
                      for k, v in shoup1.items()}


def test_lab_runs_every_candidate_under_switch(monkeypatch, capsys):
    """python -m ntt_tpu_torch.lab --device cpu --m 8 under the switch: every
    candidate of both cases equal to its plain versions; the word-32 q at
    m8, 2^27 - 2^11 + 1, takes the Solinas product, the word-64 one,
    bench_params(8, 62), is not of the form and keeps Shoup's."""
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    records = lab.main(["--device", "cpu", "--m", "8", "--batch", "8", "--no-time",
                        "--cases", "both"])
    assert [(r["case"], r["name"]) for r in records] == [
        (case, name) for case in ("u32", "u64") for name in lab.CANDIDATES]
    assert all(r["exact"] for r in records)
    assert {r["case"]: r["product"] for r in records} == {"u32": "Solinas (e=27, k=11)",
                                                          "u64": "Shoup"}
    out = capsys.readouterr().out
    assert out.count("bit-exact") == 2 * len(lab.CANDIDATES)
    assert "single product Solinas (e=27, k=11)" in out and "single product Shoup" in out


def test_cuda_default_raises_without_a_card_under_switch(monkeypatch):
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = bench_params(6, 62)
    a = np.zeros((1, p.n), dtype=np.uint64)
    for name in ("auto", "sixstep", "radix2"):
        with pytest.raises(RuntimeError, match="cuda"):
            api.fwd_ntt(a, p, name)
    with pytest.raises(RuntimeError, match="cuda"):
        api.DeviceNtt(p)
