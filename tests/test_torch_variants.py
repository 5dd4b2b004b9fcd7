"""The port's reference-family variants on the CPU ('radix2', 'radix2-u32',
'radix4', 'radix4-u32', 'radix4-w56', 'r4r2', 'seal', 'radix4x4',
'radix4-vec', 'radix4-vec-unordered', 'hexl', 'r2-16'): their twiddle
builders, dual Shoup products and transforms (the plain versions of K9
and K10), bit for bit against the JAX package (``twiddles``, ``modmath``,
``api.fwd_ntt`` / ``inv_ntt`` at jnp) and ``refmodel``, lazy
representatives included.  The JAX transforms run once each, at m <= 9,
through module-scoped fixtures; 'radix2' and 'radix4' are held against
``refmodel`` (numpy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import modmath as jmm
from ntt_tpu import params as jparams
from ntt_tpu import refmodel
from ntt_tpu import twiddles as jtw
from ntt_tpu.kernels import radix4 as jradix4
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import api
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import twiddles as ttw
from ntt_tpu_torch.kernels import layouts, mixed
from ntt_tpu_torch.kernels import radix2 as r2
from ntt_tpu_torch.params import NttParams, from_fields
from ntt_tpu_torch.plan import EXTRA_SCALARS, EXTRA_TABLES, NttPlan, get_plan

NEW = ("radix2", "radix2-u32", "radix4", "radix4-u32", "radix4-w56", "r4r2", "seal",
       "radix4x4", "radix4-vec", "radix4-vec-unordered", "hexl", "r2-16")


def rand(p, seed, hi=None, batch=2):
    return np.random.default_rng(seed).integers(0, hi or p.q, size=(batch, p.n),
                                                dtype=np.uint64)


def jp_of(bits, m):
    return jparams.NttParams.generate(bits, m)


def fwd(a, jp, name, lazy=False):
    return api.fwd_ntt(a, from_fields(jp), name, lazy=lazy, device="cpu")


def inv(a, jp, name):
    return api.inv_ntt(a, from_fields(jp), name, device="cpu")


# -- twiddle builders ----------------------------------------------------------


def _same(jax_fn, port_fn):
    try:
        want = jax_fn()
    except (IndexError, ValueError):
        with pytest.raises((IndexError, ValueError)):
            port_fn()
        return
    got = port_fn()
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", range(2, 11))
def test_twiddle_builders_equal_jax(m):
    """Every expanded layout and the word-32 / 56 / 64 constants, at a
    62-, 52- and 29-bit q; where JAX's builder fails at a small N, so does
    the port's."""
    for bits in (62, 52, 29):
        p = jp_of(bits, m)
        w = jtw.calc_w(p.w, p.n, p.q)
        _same(lambda: jtw.expand_w(w, p.q), lambda: ttw.expand_w(w, p.q))
        _same(lambda: jtw.expand_w_hexl(w), lambda: ttw.expand_w_hexl(w))
        _same(lambda: jtw.expand_w_r2_16(w), lambda: ttw.expand_w_r2_16(w))
        _same(lambda: jtw.expand_w_r4r2(w, p.q), lambda: ttw.expand_w_r4r2(w, p.q))
        for unordered in (False, True):
            _same(lambda: jtw.expand_w_r4(w, p.q, unordered),
                  lambda: ttw.expand_w_r4(w, p.q, unordered))
        r4 = jtw.expand_w(w, p.q)
        for word in (32, 56, 64):
            _same(lambda: jtw.calc_w_con(r4, p.q, word), lambda: ttw.calc_w_con(r4, p.q, word))
        assert ttw.calc_ninv_con(p.n_inv, p.q, 56) == jtw.calc_ninv_con(p.n_inv, p.q, 56)
    np.testing.assert_array_equal(ttw.LANE_PERM, jtw.LANE_PERM)
    np.testing.assert_array_equal(ttw.T2_GROUP_ORDER, jtw.T2_GROUP_ORDER)


def test_plan_tables_equal_jax_plan():
    """Every expanded table of the port's plan (the unordered vector
    tables derived from the ordered ones) equals the JAX plan's."""
    jp = jp_of(61, 9)
    jplan, plan = jax_get_plan(jp), get_plan(from_fields(jp))
    jax_names = {"w_r4_vec": lambda: jplan.w_r4_vec(False),
                 "w_r4_vec_unord": lambda: jplan.w_r4_vec(True)}
    for name in EXTRA_TABLES:
        want = jax_names.get(name, lambda: getattr(jplan, name))()
        np.testing.assert_array_equal(getattr(plan, name), want, err_msg=name)
    assert plan.n_inv_con56 == jplan.n_inv_con56


# -- dual Shoup products -------------------------------------------------------


def _operands(q, word, n=4096, seed=7):
    """Twiddles below q with their Shoup constants at ``word``, and t1, t2
    up to their bound: t1 + t2 < 16q (the radix-4 lazy inputs reach 8q)."""
    rng = np.random.default_rng(seed)
    w1, w2 = (rng.integers(0, q, n, dtype=np.uint64) for _ in range(2))
    t1, t2 = (rng.integers(0, 8 * q, n, dtype=np.uint64) for _ in range(2))
    t1[:4] = t2[:4] = 8 * q - 1  # the bound itself
    return w1, ttw.calc_w_con(w1, q, word), w2, ttw.calc_w_con(w2, q, word), t1, t2


def _t64(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint64).view(np.int64).copy())


@pytest.mark.parametrize("word,bits", [(64, 60), (56, 52), (32, 28)])
def test_dual_shoup_equals_jax(word, bits):
    """modmath's dual product at words 64 / 56 / 32 (and the single
    word-56 product) against JAX's modmath and refmodel, on operands up to
    their bounds (t1 + t2 < 16q <= 2^word); the result is below 2q and
    congruent to t1 w1 + t2 w2."""
    q = jparams.find_ntt_prime(bits, 4)
    w1, c1, w2, c2, t1, t2 = _operands(q, word)
    if word == 32:
        got = mm.to_host(mm.shoup_dbl_mul32_q2(*(torch.from_numpy(x.astype(np.uint32).view(
            np.int32)) for x in (w1, c1, w2, c2, t1, t2)), q))
        want = np.asarray(jradix4._shoup_dbl32_q2(
            *(jnp.asarray(x.astype(np.uint32)) for x in (w1, c1, w2, c2, t1, t2)), q))
        want = want.astype(np.uint64)
    else:
        dbl = mm.shoup_dbl_mul_q2 if word == 64 else mm.shoup_dbl_mul56_q2
        jdbl = jmm.shoup_dbl_mul_q2 if word == 64 else jmm.shoup_dbl_mul56_q2
        got = mm.to_host(dbl(*map(_t64, (w1, c1, w2, c2, t1, t2)), q))
        want = jmm.to_u64(jdbl(*map(jmm.from_u64, (w1, c1, w2, c2, t1, t2)), q))
        if word == 64:
            np.testing.assert_array_equal(
                got, refmodel.shoup_dbl_mul_q2(w1, c1, w2, c2, t1, t2, q))
        else:
            np.testing.assert_array_equal(
                mm.to_host(mm.shoup_mul56_q2(_t64(w1), _t64(c1), _t64(t1), q)),
                jmm.to_u64(jmm.shoup_mul56_q2(*map(jmm.from_u64, (w1, c1, t1)), q)))
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2 * q
    exact = [(int(a) * int(b) + int(c) * int(d)) % q for a, b, c, d in zip(w1, t1, w2, t2)]
    np.testing.assert_array_equal(got % np.uint64(q), np.array(exact, dtype=np.uint64))


# -- transforms against JAX ----------------------------------------------------

# (variant, bits, m, what): a JAX call each, shared through the fixture.
# 'radix4-vec' at even m has 'radix4''s values (the same quintuples in the
# same order), so refmodel stands for JAX there (test_vec_even_m_equals_
# refmodel); the odd forward of the unordered form is JAX's, and holds the
# ordered one through the layout.
JAX_CALLS = [
    ("radix2-u32", 29, 5, "lazy"), ("radix2-u32", 29, 4, "lazy"), ("radix2-u32", 29, 4, "inv"),
    ("radix4-u32", 27, 5, "lazy"), ("radix4-u32", 27, 4, "lazy"), ("radix4-u32", 27, 5, "inv"),
    ("r4r2", 27, 5, "lazy"), ("r4r2", 27, 4, "lazy"), ("r4r2", 27, 5, "inv"),
    ("r4r2", 60, 5, "lazy"), ("r4r2", 60, 8, "lazy"), ("r4r2", 60, 5, "inv"),
    ("radix4-w56", 52, 1, "lazy"), ("radix4-w56", 52, 2, "lazy"), ("radix4-w56", 52, 3, "inv"),
    ("seal", 62, 4, "inv"), ("hexl", 62, 3, "lazy"), ("hexl", 62, 4, "lazy"),
    ("r2-16", 62, 4, "lazy"), ("r2-16", 62, 5, "lazy"),
    ("radix4-vec-unordered", 60, 9, "lazy"),
]


def _input(name, jp, what):
    """Inputs below q (below 4q for hexl's forward: its input_mod_factor);
    an inverse's input is no forward's output."""
    hi = 4 * jp.q if name == "hexl" and what == "lazy" else None
    return rand(jp, jp.m + (100 if what == "inv" else 0), hi)


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for name, bits, m, what in JAX_CALLS:
        jp = jp_of(bits, m)
        a = _input(name, jp, what)
        out[name, bits, m, what] = (jax_api.fwd_ntt(a, jp, name, lazy=True) if what == "lazy"
                                    else jax_api.inv_ntt(a, jp, name))
    return out


@pytest.mark.parametrize("call", JAX_CALLS, ids=lambda c: "-".join(map(str, c)))
def test_variant_equals_jax(jax_out, call):
    """The lazy forward (the same representatives) and the inverse equal
    JAX's; the strict forward is the lazy one reduced.  The unordered
    vector forward's output, through output_layout's fix, is the ordered
    one's."""
    name, bits, m, what = call
    jp = jp_of(bits, m)
    a = _input(name, jp, what)
    want = jax_out[call]
    if what == "inv":
        np.testing.assert_array_equal(inv(a, jp, name), want)
        return
    lazy = fwd(a, jp, name, lazy=True)
    np.testing.assert_array_equal(lazy, want)
    np.testing.assert_array_equal(fwd(a, jp, name), lazy % np.uint64(jp.q))
    if name == "radix4-vec-unordered":
        np.testing.assert_array_equal(fwd(a, jp, "radix4-vec", lazy=True),
                                      layouts.radix4_vec_unordered(jp.n).fix(want))


@pytest.mark.parametrize("m", [8, 10])
def test_vec_even_m_equals_refmodel(m):
    """At even log2 N the vector forms run 'radix4''s stages on the same
    quintuples, so refmodel's radix-4 forward and inverse are their
    reference: lazy forward (the unordered one through the layout) and
    both inverses (the unordered one on the layout's input)."""
    jp = jp_of(60, m)
    jplan = jax_get_plan(jp)
    a, b = rand(jp, m), rand(jp, m + 1)
    want = refmodel.fwd_ntt_radix4_lazy(a, jp.q, jplan.w_r4, jplan.w_r4_con)
    unord = layouts.radix4_vec_unordered(jp.n)
    np.testing.assert_array_equal(fwd(a, jp, "radix4-vec", lazy=True), want)
    np.testing.assert_array_equal(fwd(a, jp, "radix4-vec-unordered", lazy=True),
                                  unord.unfix(want))
    want_inv = refmodel.inv_ntt_radix4(b, jp.q, jp.n_inv, jplan.n_inv_con, jplan.w_inv_r4,
                                       jplan.w_inv_r4_con)
    np.testing.assert_array_equal(inv(b, jp, "radix4-vec"), want_inv)
    np.testing.assert_array_equal(inv(unord.unfix(b), jp, "radix4-vec-unordered"), want_inv)


@pytest.mark.parametrize("m", [7, 9])
def test_r4r2_table_path_equals_expand_path(m):
    """The r4r2 forward over the 5N layout (the JAX dispatch at word 64
    from N = 128) gives the 2N-table path's values at odd m too."""
    p = NttParams.generate(60, m)
    plan = get_plan(p)
    a = mm.from_host(rand(p, m), p.q, "cpu")
    for strict in (False, True):
        assert torch.equal(mixed.fwd(a, plan, 64, strict),
                           r2.run(a, plan, mixed.fwd_launches(p.n, strict, False), 64))


@pytest.mark.parametrize("bits,m", [(62, 3), (62, 4), (29, 5), (29, 4), (61, 6)])
def test_radix2_family_equals_refmodel(bits, m):
    """'radix2', 'seal' (whose forward has the Harvey chain's values) and
    'radix4x4' (the register rounds: the flat radix-2 bits) lazy and strict
    against refmodel's Harvey forward, their inverses against refmodel's
    (SEAL's final stage rounds the same values); at a 29-bit q 'radix2'
    and 'seal' compute at word 64 on the int32 rep, 'radix4x4' at word 32
    and equals 'radix2-u32'."""
    jp = jp_of(bits, m)
    jplan = jax_get_plan(jp)
    a, b = rand(jp, m), rand(jp, m + 1)
    want = refmodel.fwd_ntt_harvey_lazy(a, jp.q, jplan.w, jplan.w_con)
    want_inv = refmodel.inv_ntt_harvey(b, jp.q, jp.n_inv, jplan.n_inv_con, jplan.w_inv,
                                       jplan.w_inv_con)
    names = ("radix2", "seal") + (("radix4x4",) if bits > 30 else ())
    for name in names:
        np.testing.assert_array_equal(fwd(a, jp, name, lazy=True), want, err_msg=name)
        np.testing.assert_array_equal(fwd(a, jp, name), want % np.uint64(jp.q), err_msg=name)
        np.testing.assert_array_equal(inv(b, jp, name), want_inv, err_msg=name)
    if bits <= 30:
        np.testing.assert_array_equal(fwd(a, jp, "radix4x4", lazy=True),
                                      fwd(a, jp, "radix2-u32", lazy=True))
        np.testing.assert_array_equal(inv(b, jp, "radix4x4"), want_inv)


@pytest.mark.parametrize("bits,m", [(60, 5), (60, 6), (29, 4), (29, 3), (60, 1)])
def test_radix4_equals_refmodel(bits, m):
    """'radix4' lazy (< 8q for even log2 N, < 4q for odd) and strict
    against refmodel's radix-4 forward, its inverse against refmodel's."""
    jp = jp_of(bits, m)
    jplan = jax_get_plan(jp)
    a, b = rand(jp, m), rand(jp, m + 1)
    want = refmodel.fwd_ntt_radix4_lazy(a, jp.q, jplan.w_r4, jplan.w_r4_con)
    got = fwd(a, jp, "radix4", lazy=True)
    np.testing.assert_array_equal(got, want)
    assert got.max() < (8 if m % 2 == 0 else 4) * jp.q
    np.testing.assert_array_equal(fwd(a, jp, "radix4"), want % np.uint64(jp.q))
    np.testing.assert_array_equal(
        inv(b, jp, "radix4"),
        refmodel.inv_ntt_radix4(b, jp.q, jp.n_inv, jplan.n_inv_con, jplan.w_inv_r4,
                                jplan.w_inv_r4_con))


# -- the registry ---------------------------------------------------------------


R4_FAMILY = ("radix4", "r4r2", "radix4-vec", "radix4-vec-unordered")


def test_registry_holds_the_jax_variants():
    """Every JAX variant, with JAX's max_q_bits (mxu's 28 too), but 60 for
    the word-64 radix-4 variants (JAX: 61, test_radix4_cap_below_2_61); no
    two variants share a forward callable."""
    port, jax_reg = api.variants(), jax_api.variants()
    assert not set(jax_reg) - set(port)
    assert port["mxu"].max_q_bits == jax_reg["mxu"].max_q_bits == 28
    for name in NEW:
        want = 60 if name in R4_FAMILY else jax_reg[name].max_q_bits
        assert port[name].max_q_bits == want, name
    assert all(jax_reg[name].max_q_bits == 61 for name in R4_FAMILY)
    fwds = [v.fwd for v in port.values()]
    assert len(set(map(id, fwds))) == len(fwds)


def test_radix4_cap_below_2_61():
    """At a 61-bit q the dual Shoup product of the radix-4 butterfly can
    reach 3q: on this input refmodel's radix-4 forward (which JAX's
    'radix4' equals, lazy bits included) is not the NTT.  The port takes
    q < 2^60 for the word-64 radix-4 variants and raises above."""
    jp = jp_of(61, 10)
    jplan = jax_get_plan(jp)
    a = rand(jp, 55, batch=64)[35:36]
    r4 = refmodel.fwd_ntt_radix4_lazy(a, jp.q, jplan.w_r4, jplan.w_r4_con) % np.uint64(jp.q)
    assert not np.array_equal(r4, refmodel.fwd_ntt_harvey(a, jp.q, jplan.w, jplan.w_con))
    for name in R4_FAMILY:
        with pytest.raises(ValueError, match="supports q < 2\\^60"):
            fwd(a, jp, name)


def test_whole_registry_strict_agrees():
    """Strict forwards of every variant equal after output_layout's fix
    (and equal the NTT by its definition), and every inverse brings them
    back, at q = 0xfff0001 (below 2^28, so every variant takes it) and
    m = 8 (the vector forms need N >= 256)."""
    p = NttParams.make(0xFFF0001, 8)
    a = rand(p, 3, batch=3)
    ref = refmodel.direct_negacyclic_ntt(a[0], p.q, p.w)
    for name in api.variants():
        out = api.fwd_ntt(a, p, name, device="cpu")
        np.testing.assert_array_equal(api.output_layout(name, p).fix(out)[0], ref, err_msg=name)
        np.testing.assert_array_equal(api.inv_ntt(out, p, name, device="cpu"), a, err_msg=name)


def test_word64_variants_on_int32_tensors():
    """At a 30-bit q (int32 rep) the word-64 variants compute on an int64
    copy: strict and inverse outputs come back as int32 equal to the numpy
    path's; a lazy 'radix4' at even m (bound 8q > 2^32) and any lazy
    'radix4-vec' raise, while odd m (4q) and 'r4r2' (4q) narrow back."""
    p = NttParams.generate(30, 8)
    plan = get_plan(p)
    assert plan.dtype == torch.int32
    a = rand(p, 11)
    t = mm.from_host(a, p.q, "cpu")
    for name in ("radix2", "radix4", "radix4-w56", "r4r2", "seal", "hexl", "r2-16",
                 "radix4-vec"):
        f = api.fwd_ntt(t, p, name)
        assert f.dtype == torch.int32
        np.testing.assert_array_equal(mm.to_host(f), api.fwd_ntt(a, p, name, device="cpu"))
        back = api.inv_ntt(f, p, name)
        assert back.dtype == torch.int32 and torch.equal(back, t)
    for name in ("radix4", "radix4-w56", "radix4-vec"):
        with pytest.raises(ValueError, match="int32"):
            api.fwd_ntt(t, p, name, lazy=True)
    lazy = api.fwd_ntt(t, p, "r4r2", lazy=True)
    np.testing.assert_array_equal(mm.to_host(lazy), api.fwd_ntt(a, p, "r4r2", lazy=True,
                                                                 device="cpu"))
    p7 = NttParams.generate(30, 7)
    t7 = mm.from_host(rand(p7, 12), p7.q, "cpu")
    np.testing.assert_array_equal(
        mm.to_host(api.fwd_ntt(t7, p7, "radix4", lazy=True)),
        api.fwd_ntt(mm.to_host(t7), p7, "radix4", lazy=True, device="cpu"))
    # numpy input goes in as int64: the lazy values of 'radix4' at even m,
    # up to 8q > 2^32, come back whole
    wide = api.fwd_ntt(a, p, "radix4", lazy=True, device="cpu")
    np.testing.assert_array_equal(wide % np.uint64(p.q), mm.to_host(api.fwd_ntt(t, p, "radix4")))


def test_vec_unordered_layout_and_inverse():
    """output_layout's fix takes the unordered forward to the ordered one
    and unfix back; the unordered inverse reads that layout as it is."""
    p = NttParams.generate(60, 9)
    a = rand(p, 13)
    lay = api.output_layout("radix4-vec-unordered", p)
    unord = api.fwd_ntt(a, p, "radix4-vec-unordered", lazy=True, device="cpu")
    ordered = api.fwd_ntt(a, p, "radix4-vec", lazy=True, device="cpu")
    assert not np.array_equal(unord, ordered)
    np.testing.assert_array_equal(lay.fix(unord), ordered)
    np.testing.assert_array_equal(lay.unfix(ordered), unord)
    np.testing.assert_array_equal(api.inv_ntt(unord, p, "radix4-vec-unordered", device="cpu"), a)
    b = rand(p, 14)
    np.testing.assert_array_equal(api.inv_ntt(b, p, "radix4-vec-unordered", device="cpu"),
                                  api.inv_ntt(lay.fix(b), p, "radix4-vec", device="cpu"))


@pytest.mark.parametrize("name,m", [("hexl", 2), ("r2-16", 3), ("radix4-vec", 7),
                                    ("radix4-vec-unordered", 7)])
def test_sizes_below_a_variant_raise(name, m):
    """Below the least N JAX's variant takes, the port raises."""
    p = NttParams.generate(60, m)
    with pytest.raises(ValueError, match="needs m >="):
        api.fwd_ntt(rand(p, 1), p, name, device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    """numpy input with the default device="cuda" raises where there is no
    card: nothing falls back to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = NttParams.generate(60, 4)
    for name in ("radix2", "radix4", "r4r2"):
        with pytest.raises(RuntimeError, match="cuda"):
            api.fwd_ntt(rand(p, 1), p, name)


def test_tables_carried_across_from_jax():
    """NttPlan.from_numpy with the JAX plan's tables, the expanded ones
    included, gives the same outputs as the port's own plan."""
    jp = jp_of(60, 8)
    jplan = jax_get_plan(jp)
    tables = {k: getattr(jplan, k) for k in
              ("w", "w_con", "w_inv", "w_inv_con", "w_con32", "w_inv_con32", "n_inv_con",
               "n_inv_con32", *EXTRA_SCALARS)}
    for k in EXTRA_TABLES:
        tables[k] = (jplan.w_r4_vec(k.endswith("unord")) if k in ("w_r4_vec", "w_r4_vec_unord")
                     else getattr(jplan, k))
    p = from_fields(jp)
    carried = NttPlan.from_numpy(p, tables)
    a = rand(jp, 21)
    for name in (n for n in NEW if api.get_variant(n).max_q_bits >= 60):
        out = api.fwd_ntt(a, carried, name, lazy=True, device="cpu")
        np.testing.assert_array_equal(out, api.fwd_ntt(a, p, name, lazy=True, device="cpu"),
                                      err_msg=name)
        np.testing.assert_array_equal(api.inv_ntt(out, carried, name, device="cpu"),
                                      api.inv_ntt(out, p, name, device="cpu"), err_msg=name)
