"""The port's two-level six-step ('sixstep-rec') on the CPU: its twist
tables, prime scan, plain twist, K7 with the level-1 constants and the
variant itself, bit for bit against the JAX package (``twiddles.
twist_tables_rec``, ``params.find_ntt_primes``, ``sixstep._twist_mul``,
the level-1 ``inv_sixstep`` and ``api.fwd_ntt`` / ``inv_ntt`` with
``variant="sixstep-rec"``, all jnp), and strict against the port's flat
'sixstep'.  The JAX calls stay at m <= 9, one per (m, width, direction)
through module-scoped fixtures."""

import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import params as jparams
from ntt_tpu import twiddles as jtw
from ntt_tpu.kernels import sixstep as jsixstep
from ntt_tpu.kernels.elems import U32Ops as JU32Ops
from ntt_tpu.kernels.elems import U64Ops as JU64Ops
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import api, native, trace
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import params as tparams
from ntt_tpu_torch import twiddles as ttw
from ntt_tpu_torch.kernels import rec, twopass
from ntt_tpu_torch.params import NttParams, from_fields
from ntt_tpu_torch.plan import get_plan

WIDTH_BITS = (29, 62)  # word 32 and word 64


def rand(p, shape, seed, hi=None):
    return np.random.default_rng(seed).integers(0, hi or p.q, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("m", range(4, 13))
def test_twist_tables_equal_jax(m):
    """Both directions at both widths, at rec's split."""
    for bits in WIDTH_BITS:
        p = NttParams.generate(bits, m)
        for psi in (p.w, p.w_inv):
            want = jtw.twist_tables_rec(psi, p.q, p.n, m // 2)
            got = ttw.twist_tables_rec(psi, p.q, p.n, m // 2)
            for g, w in zip(got, want):
                assert g.dtype == np.uint64
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits,m,count", [(30, 6, 3), (29, 6, 2), (30, 14, 4), (62, 16, 3),
                                          (20, 12, 2)])
def test_find_ntt_primes_equals_jax(bits, m, count):
    assert tparams.find_ntt_primes(bits, m, count) == jparams.find_ntt_primes(bits, m, count)
    assert tparams.find_ntt_prime(bits, m, count - 1) == jparams.find_ntt_primes(
        bits, m, count)[-1]
    with pytest.raises(ValueError):
        tparams.find_ntt_primes(13, 12, 1)


@pytest.mark.parametrize("bits", WIDTH_BITS)
@pytest.mark.parametrize("m,inverse", [(5, False), (8, True)])
def test_plain_twist_mul_equals_jax(bits, m, inverse):
    """sixstep.twist_mul (K8's plain version, and the CPU route of its
    wrapper) on inputs below 4q equals JAX's _twist_mul on the same reps."""
    jp = jparams.NttParams.generate(bits, m)
    jplan = jax_get_plan(jp)
    ops = JU32Ops if jplan.supports_u32_radix2 else JU64Ops
    l1 = jsixstep.rec_split(m)
    a = rand(jp, (3, jp.n), m, hi=4 * jp.q)
    tw = jax_api._rec_twist_reps(jplan, l1, inverse, ops)
    lead = (3,)
    rep = tuple(x.reshape(lead + (1 << l1, jp.n >> l1)) for x in ops.from_host(a))
    want = ops.to_host(jsixstep._twist_mul(rep, ops, tw, jp.q, 1 << l1, lead)).reshape(a.shape)
    p = from_fields(jp)
    got = rec.twist_mul(mm.from_host(a, p.q, "cpu"), get_plan(p), l1, inverse)
    np.testing.assert_array_equal(mm.to_host(got), want)
    assert want.max() < 2 * jp.q


JAX_CELLS = [(m, bits) for m in (4, 5, 9) for bits in WIDTH_BITS]


@pytest.fixture(scope="module", params=JAX_CELLS, ids=lambda c: f"m{c[0]}-q{c[1]}")
def jax_rec(request):
    """JAX sixstep-rec at one (m, width): forward strict and lazy, and the
    inverse of the strict forward."""
    m, bits = request.param
    jp = jparams.NttParams.generate(bits, m)
    a = rand(jp, (3, jp.n), 100 + m)
    fwd = {lazy: jax_api.fwd_ntt(a, jp, variant="sixstep-rec", lazy=lazy)
           for lazy in (False, True)}
    return jp, a, fwd, jax_api.inv_ntt(fwd[False], jp, variant="sixstep-rec")


@pytest.mark.parametrize("lazy", [False, True], ids=["strict", "lazy"])
def test_rec_forward_equals_jax(jax_rec, lazy):
    jp, a, fwd, _ = jax_rec
    got = api.fwd_ntt(a, from_fields(jp), variant="sixstep-rec", lazy=lazy, device="cpu")
    np.testing.assert_array_equal(got, fwd[lazy])


def test_rec_inverse_equals_jax(jax_rec):
    jp, a, fwd, inv = jax_rec
    got = api.inv_ntt(fwd[False], from_fields(jp), variant="sixstep-rec", device="cpu")
    np.testing.assert_array_equal(got, inv)
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("bits", WIDTH_BITS)
@pytest.mark.parametrize("m", range(2, 15))
def test_rec_strict_equals_flat_sixstep(m, bits):
    """Strict, the two levels give the flat six-step's bits; the inverse
    undoes either; the plain compositions chip_smoke holds the launches
    against give the same bits as the CPU route of the launches."""
    p = NttParams.generate(bits, m)
    plan = get_plan(p)
    a = rand(p, (2, p.n), m)
    f = api.fwd_ntt(a, p, variant="sixstep-rec", device="cpu")
    np.testing.assert_array_equal(f, api.fwd_ntt(a, p, variant="sixstep", device="cpu"))
    np.testing.assert_array_equal(api.inv_ntt(f, p, variant="sixstep-rec", device="cpu"), a)
    t = mm.from_host(a, p.q, "cpu")
    for strict in (True, False):
        assert torch.equal(rec.fwd_rec(t, plan, strict), rec.plain_fwd(t, plan, strict))
    ft = mm.from_host(f, p.q, "cpu")
    assert torch.equal(rec.inv_rec(ft, plan), rec.plain_inv(ft, plan))


@pytest.mark.parametrize("bits", WIDTH_BITS)
@pytest.mark.parametrize("m", [5, 8])
def test_inv_cols_with_level1_constants_equals_jax_level1_inverse(m, bits):
    """K7 (its CPU route) on the (N1, N2) view with the level-1 plan's
    tables and 1/N1 constants equals JAX's level-1 inv_sixstep of the
    columns on inputs below 2q (the inverse twist's output range)."""
    jp = jparams.NttParams.generate(bits, m)
    jplan = jax_get_plan(jp)
    word = 32 if jplan.supports_u32_radix2 else 64
    l1 = jsixstep.rec_split(m)
    n1, n2 = 1 << l1, jp.n >> l1
    pl1, _ = jax_api._rec_level_plans(jplan, l1)
    a = rand(jp, (2, jp.n), 7 * m, hi=2 * jp.q)
    cols = a.reshape(2, n1, n2).swapaxes(-1, -2)
    want = jax_api.inv_ntt(cols, pl1, variant="sixstep")  # inv_sixstep on pl1's tables
    want = want.swapaxes(-1, -2).reshape(2, jp.n)
    plan = get_plan(from_fields(jp))
    plan1, _ = plan.rec_plans(l1)
    assert plan1.inv_consts == jax_api._rec_ninv(pl1, word)
    assert int(plan1.w_inv[1]) == int(plan.w_inv[1])  # psi^(-N/2) at both levels
    got = twopass.inv_cols(mm.from_host(a, jp.q, "cpu"), plan, l1, col_plan=plan1)
    np.testing.assert_array_equal(mm.to_host(got), want)
    with pytest.raises(ValueError, match="column plan"):
        twopass.inv_cols(mm.from_host(a, jp.q, "cpu"), plan, l1 + 1, col_plan=plan1)


def test_rec_needs_m2_and_cpu_route_launches_nothing(monkeypatch):
    before = trace.LAUNCHES.copy()

    def no_launch(*args):
        raise AssertionError("the CPU route launched a kernel")

    monkeypatch.setattr(native, "launch", no_launch)
    p = NttParams.generate(62, 6)
    a = rand(p, (2, p.n), 5)
    api.negacyclic_mul(a, a, p, variant="sixstep-rec", device="cpu")
    assert trace.LAUNCHES == before
    p1 = NttParams.generate(29, 1)
    with pytest.raises(ValueError, match="m >= 2"):
        api.fwd_ntt(rand(p1, (1, 2), 1), p1, variant="sixstep-rec", device="cpu")


def test_rec_default_device_is_cuda_and_never_falls_back():
    p = NttParams.generate(29, 6)
    a = rand(p, (1, p.n), 2)
    if torch.cuda.is_available():
        np.testing.assert_array_equal(api.fwd_ntt(a, p, variant="sixstep-rec"),
                                      api.fwd_ntt(a, p, variant="sixstep-rec", device="cpu"))
        return
    with pytest.raises(RuntimeError, match="is_available"):
        api.fwd_ntt(a, p, variant="sixstep-rec")


def test_negacyclic_mul_through_rec_equals_sixstep():
    """negacyclic_mul with variant='sixstep-rec' composes the variant's
    forwards, the pointwise product and its inverse, as JAX's does."""
    p = NttParams.generate(62, 7)
    a, b = rand(p, (3, p.n), 11), rand(p, (3, p.n), 12)
    np.testing.assert_array_equal(
        api.negacyclic_mul(a, b, p, variant="sixstep-rec", device="cpu"),
        api.negacyclic_mul(a, b, p, variant="sixstep", device="cpu"))
    layout = api.output_layout("sixstep-rec", p)
    assert layout.name == "standard"
    np.testing.assert_array_equal(layout.perm, np.arange(p.n))


def test_auto_takes_rec_only_at_its_cells(monkeypatch):
    """'auto' routes to sixstep-rec at a (width, m) cell of REC_CELLS within
    its range of batches, and only with the call's batch; strict bits are
    the same."""
    p = NttParams.generate(29, 9)
    plan = get_plan(p)
    monkeypatch.setattr(api, "REC_CELLS", {(32, 9): (2, 4)})
    assert api._pick(plan, "auto", rows=2).name == "sixstep-rec"
    assert api._pick(plan, "auto", rows=4).name == "sixstep-rec"
    assert api._pick(plan, "auto", rows=1).name == "pallas-fused"
    assert api._pick(plan, "auto", rows=5).name == "pallas-fused"
    assert api._pick(plan, "auto").name == "pallas-fused"
    assert api._pick(get_plan(NttParams.generate(62, 9)), "auto", rows=1).name == "pallas-fused"
    calls, twist = [], rec.twist_mul

    def spy(*args, **kwargs):
        calls.append(1)
        return twist(*args, **kwargs)

    monkeypatch.setattr(rec, "twist_mul", spy)
    a = rand(p, (3, p.n), 13)
    f = api.fwd_ntt(a, p, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(f, api.fwd_ntt(a, p, variant="pallas-fused", device="cpu"))
    np.testing.assert_array_equal(api.inv_ntt(f, p, device="cpu"), a)
    assert calls == [1, 1]


def test_chip_smoke_bounds_the_twist():
    """K8's bound in chip_smoke: its words read and written once and its
    four tables read once, at 3.35 TB/s; bytes bound it (82.6 us at m24
    batch 1 word 64, 41.3 at word 32)."""
    import chip_smoke

    assert chip_smoke.REPLACES["twist_mul"] == "ntt_tpu/kernels/sixstep.py:465"
    assert chip_smoke.SOURCES["twist_mul"] == "ntt_tpu_torch/csrc/twist.cu"
    for word, want_us in ((64, 82.6), (32, 41.3)):
        ms, by = chip_smoke.bound(*chip_smoke.kernel_work("twist_mul", 24, 12, 1, word))
        assert by == "bytes" and round(ms * 1e3, 1) == want_us
    assert "ntt_twist_mul_u64" in native.SIGNATURES
