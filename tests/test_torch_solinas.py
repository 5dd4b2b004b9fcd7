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
from ntt_tpu_torch.kernels import fused, fused_lab, probes, radix2, radix4, rec, twopass
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
    """csrc/modarith.cuh's two Solinas products, compiled for the host with
    g++ into a temporary shared library, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ not found: the host check of csrc/modarith.cuh needs it")
    tmp = tmp_path_factory.mktemp("modarith")
    src = tmp / "folds.cpp"
    src.write_text(
        '#include "modarith.cuh"\n'
        '#define FOLDS(T, NAME) extern "C" void NAME(const T* w, const T* t, T* out, long n, '
        "int e, int k) { for (long i = 0; i < n; ++i) "
        "out[i] = ntt::solinas_mul_q2(w[i], t[i], e, k); }\n"
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

# Runs in a subprocess whose environment has NTT_MULMOD=solinas: the JAX
# package reads the switch at import.  Its calls compile in a few threads.
_JAX_SCRIPT = r"""
import json, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from ntt_tpu import api, modmath, params
assert modmath.USE_SOLINAS
calls, path = json.loads(sys.argv[1]), sys.argv[2]

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

with ThreadPoolExecutor(4) as ex:
    outs = list(ex.map(run, calls))
np.savez(path, *outs)
"""


def call_id(c):
    return "-".join(map(str, c))


@pytest.fixture(scope="module")
def jax_switched(tmp_path_factory):
    """The JAX package's outputs of JAX_CALLS under NTT_MULMOD=solinas."""
    path = tmp_path_factory.mktemp("solinas") / "jax.npz"
    env = dict(os.environ, NTT_MULMOD="solinas", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("NTT_MULHI64", None)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(JAX_CALLS), str(path)],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    data = np.load(path)
    return {tuple(c): data[f"arr_{i}"] for i, c in enumerate(JAX_CALLS)}


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


def test_word56_launches_shoup_under_switch(fake_card, monkeypatch):
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    p = NttParams.make(Q51, 6)
    plan = get_plan(p)
    x = mm.from_host(np.zeros((1, p.n), dtype=np.uint64), Q51, "cpu")
    tabs = plan.device_tables("cpu")
    radix4.r4_stage(x, tabs.table("w_r4", 56), tabs.table(radix2.con_name("w_r4", 56), 56),
                    radix4.R4Stage(lt=0), Q51, 56, radix2.consts_at(plan, 56))
    assert [n for n, _ in fake_card] == ["r4_stage_w56"]


def test_lab_raises_under_switch(monkeypatch):
    """The lab's kernels have no Solinas instantiation: under the switch at a
    q of the form the lab, its wrappers and its CLI raise (on the CPU too);
    off the switch, or at a q it does not take, they run."""
    p = bench_params(8, 62, solinas=True)
    plan = get_plan(p)
    x = mm.from_host(np.zeros((1, p.n), dtype=np.uint64), p.q, "cpu")
    monkeypatch.setattr(mm, "USE_SOLINAS", True)
    for call in (lambda: fused_lab.fwd_fused_v2(x, plan, 4),
                 lambda: fused_lab.fwd_fused_v3(x, plan, 4),
                 lambda: probes.diag_math(x, plan, 2),
                 # the lab's word-64 q at m14 is the headline, 2^62 - 2^16 + 1
                 lambda: lab.main(["--device", "cpu", "--m", "14", "--batch", "2", "--no-time",
                                   "--cases", "u64"])):
        with pytest.raises(RuntimeError, match="Solinas"):
            call()
    other = NttParams.make(FIXTURES[9].q, 8)  # not of the word-32 form
    y = mm.from_host(np.zeros((1, other.n), dtype=np.uint64), other.q, "cpu")
    fused_lab.fwd_fused_v3(y, get_plan(other), 4)
    monkeypatch.setattr(mm, "USE_SOLINAS", False)
    fused_lab.fwd_fused_v2(x, plan, 4)


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
