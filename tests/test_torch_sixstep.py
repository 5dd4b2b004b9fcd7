"""The two-pass six-step (ntt_tpu_torch.kernels.twopass: K4 to K7 and their
plain versions) against the JAX package, pass by pass and as a whole.

Each pass on the CPU route against its JAX counterpart: fwd_cols against
sixstep.fwd_phase1, fwd_rows against fwd_phase2 with the transposes,
inv_rows against the Pallas _inv_rows_kernel (A3) and inv_cols against the
Pallas _inv_cols_kernel (A4), both in interpret mode.  Then the variants
through the API, and the four reference fixtures beyond one block through
'auto'.  Exact equality throughout, lazy representatives included."""

import functools

import jax
import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import refmodel as rm
from ntt_tpu.kernels import elems as jel
from ntt_tpu.kernels import pallas_fused as pf
from ntt_tpu.kernels import sixstep as jsix
from ntt_tpu.params import FIXTURES as JFIXTURES
from ntt_tpu.params import NttParams as JNttParams
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import api
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import fused, sixstep, twopass
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.params import FIXTURES, from_fields
from ntt_tpu_torch.plan import get_plan

from conftest import fixture_id

# Pass by pass against the JAX package: a word-32 q at JAX's split (N1 = 2
# at m = 8) and a word-64 q at another split with N1 >= 4 and N2 >= 4 (a
# wrong row-twiddle index breaks some rows only).  The other two
# combinations are held against refmodel through the whole transform, which
# any split must match bit for bit.
JAX_CASES = [(JFIXTURES[0], None), (JNttParams.generate(62, 9), 5)]
REF_CASES = [(JFIXTURES[2], 4), (JNttParams.generate(62, 10), None)]  # m = 10
BATCH = 2


def case_id(c):
    p, n1_log = c
    return f"{fixture_id(p)},n1_log={'jax' if n1_log is None else n1_log}"


def rand(p, shape, seed, hi=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.q if hi is None else hi, size=shape, dtype=np.uint64)


class Case:
    """One (params, split): the port's plan and ops, the JAX reps, and
    helpers between numpy uint64 (batch, N) and either side."""

    def __init__(self, jp, n1_log):
        self.jp = jp
        self.plan, self.ops = get_plan(from_fields(jp)), pick_ops(jp.q)
        self.word = self.plan.word
        self.n1_log = sixstep.word_split(jp.n, self.word) if n1_log is None else n1_log
        self.n1, self.n2 = 1 << self.n1_log, jp.n >> self.n1_log
        jplan = jax_get_plan(jp)
        if self.word == 32:
            self.jops = jel.U32Ops
            w, wc, _, _ = jplan.dev_r2_u32
            self.jw, self.jwc = (w,), (wc,)
            self.host_con = jplan.w_con32, jplan.w_inv_con32
        else:
            self.jops = jel.U64Ops
            self.jw, self.jwc = jplan.dev_r2_u64[:2]
            self.host_con = jplan.w_con, jplan.w_inv_con
        self.jplan = jplan

    def t(self, a):
        return mm.from_host(a, self.jp.q, "cpu")

    def jrep(self, a, shape):
        return tuple(l.reshape(shape) for l in self.jops.from_host(a))

    def jhost(self, rep):
        return self.jops.to_host(tuple(l.reshape(BATCH, self.jp.n) for l in rep))

    def transpose(self, a, rows, cols):
        """numpy (batch, N) flattened (rows, cols) -> flattened (cols, rows)."""
        return a.reshape(BATCH, rows, cols).swapaxes(1, 2).reshape(BATCH, -1)


@pytest.fixture(scope="module", params=JAX_CASES, ids=case_id)
def case(request):
    return Case(*request.param)


def test_fwd_cols_matches_fwd_phase1(case):
    a = rand(case.jp, (BATCH, case.jp.n), 1, hi=4 * case.jp.q)  # lazy input
    got = twopass.fwd_cols(case.t(a), case.plan, case.n1_log)
    fn = jax.jit(lambda r, w, wc: jsix.fwd_phase1(r, case.jops, w, wc, case.jp.q,
                                                  case.n1, case.n2))
    want = fn(case.jrep(a, (BATCH, case.n1, case.n2)), case.jw, case.jwc)
    np.testing.assert_array_equal(mm.to_host(got), case.jhost(want))


@pytest.fixture(scope="module")
def jax_rows(case):
    """JAX's fwd_phase2 (lazy, strict) on the transposed fwd_rows input."""
    a = rand(case.jp, (BATCH, case.jp.n), 2, hi=4 * case.jp.q)
    rep = case.jrep(case.transpose(a, case.n1, case.n2), (BATCH, case.n2, case.n1))

    def both(r, w, wc):
        return [jsix.fwd_phase2(r, case.jops, w, wc, case.jp.q, case.n1, case.n2, 0,
                                case.n1, strict=strict) for strict in (False, True)]

    lazy, strict = jax.jit(both)(rep, case.jw, case.jwc)
    return a, {False: case.jhost(lazy), True: case.jhost(strict)}


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lazy"])
@pytest.mark.parametrize("keep_transposed", [False, True], ids=["std", "keep_t"])
def test_fwd_rows_matches_fwd_phase2(case, jax_rows, strict, keep_transposed):
    a, outs = jax_rows
    got = twopass.fwd_rows(case.t(a), case.plan, case.n1_log, strict, keep_transposed)
    want = outs[strict]  # (N2, N1) layout
    if not keep_transposed:
        want = case.transpose(want, case.n2, case.n1)
    np.testing.assert_array_equal(mm.to_host(got), want)


def _pallas(case, kernel, inverse_tables, a3, in3, out3):
    """One pallas_call of the phase-split inverse in interpret mode."""
    nlimb = case.jops.nlimb
    tables = pf.build_tables(case.jplan.w_inv, case.host_con[1], case.n1, case.n2, nlimb)
    tabs = tables[2 * nlimb:] if inverse_tables == "rows" else tables[: 2 * nlimb]
    out = pf._call3(lambda *refs: kernel(refs), a3, tabs, in3, out3, BATCH, BATCH, True)
    return case.jhost(out)


@pytest.fixture(scope="module")
def pallas_inverse(case):
    """The JAX two-launch Pallas inverse in interpret mode: A3
    (_inv_rows_kernel) on f, then A4 (_inv_cols_kernel) on A3's output."""
    f = rand(case.jp, (BATCH, case.jp.n), 3)
    nlimb, q = case.jops.nlimb, case.jp.q
    tables = pf.build_tables(case.jplan.w_inv, case.host_con[1], case.n1, case.n2, nlimb)
    k3 = functools.partial(pf._inv_rows_kernel, case.jops, q, case.n1, case.n2, nlimb)
    k4 = functools.partial(pf._inv_cols_kernel, case.jops, q, case.n1, case.n2,
                           *case.plan.inv_consts, nlimb)
    mid = pf._call3(lambda *refs: k3(refs), case.jrep(f, (BATCH, case.n1, case.n2)),
                    tables[2 * nlimb:], (case.n1, case.n2), (case.n2, case.n1), BATCH,
                    BATCH, True)
    out = pf._call3(lambda *refs: k4(refs), mid, tables[: 2 * nlimb], (case.n2, case.n1),
                    (case.n1, case.n2), BATCH, BATCH, True)
    return f, case.jhost(mid), case.jhost(out)


@pytest.mark.parametrize("input_transposed", [False, True], ids=["std", "from_t"])
def test_inv_rows_matches_pallas_inv_rows_kernel(case, pallas_inverse, input_transposed):
    """K6's plain version against A3, which writes the (N2, N1) layout."""
    f, mid, _ = pallas_inverse
    x = case.transpose(f, case.n1, case.n2) if input_transposed else f
    got = twopass.inv_rows(case.t(x), case.plan, case.n1_log, input_transposed)
    np.testing.assert_array_equal(mm.to_host(got), case.transpose(mid, case.n2, case.n1))


def test_inv_cols_matches_pallas_inv_cols_kernel(case, pallas_inverse):
    """K7's plain version against A4, which reads the (N2, N1) layout."""
    _, mid, out = pallas_inverse
    got = twopass.inv_cols(case.t(case.transpose(mid, case.n2, case.n1)), case.plan,
                           case.n1_log)
    np.testing.assert_array_equal(mm.to_host(got), out)


def test_wide_final_constant(case):
    """inv_cols with a final-stage Shoup constant one bit wider than the
    word (no valid params produce one; test_torch_modmath holds that
    element op against JAX's) equals the one-pass plain inverse at another
    split with the same constants."""
    p, word = case.jp, case.word
    tmp = p.q + p.q // 3  # a lazy tmp in [q, 2q)
    con = (tmp << word) // p.q
    assert con >> word == 1
    x = case.t(rand(p, (BATCH, p.n), 6, hi=2 * p.q))
    n_inv, n_inv_con = case.plan.inv_consts[:2]
    tabs = case.plan.device_tables("cpu")
    consts = (n_inv, n_inv_con, tmp, con, p.q)
    rows = sixstep.inv_rows(x, case.ops, tabs.w_inv, tabs.w_inv_con, p.q, case.n1_log)
    got = sixstep.inv_cols(rows, case.ops, tabs.w_inv, tabs.w_inv_con, *consts, case.n1_log)
    want = sixstep.inv_sixstep(x, case.ops, tabs.w_inv, tabs.w_inv_con, *consts,
                               sixstep.balanced_split(p.n) + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", JAX_CASES + REF_CASES, ids=case_id)
def test_two_passes_match_refmodel(c):
    """fwd_cols -> fwd_rows and inv_rows -> inv_cols at any split equal the
    flat radix-2 transform of refmodel (word 64 also lazy)."""
    jp, n1_log = c
    p = from_fields(jp)
    plan = get_plan(p)
    n1_log = sixstep.word_split(p.n, plan.word) if n1_log is None else n1_log
    a = rand(p, (BATCH, p.n), 7)
    t = mm.from_host(a, p.q, "cpu")
    lazy = twopass.fwd_rows(twopass.fwd_cols(t, plan, n1_log), plan, n1_log, strict=False)
    strict = twopass.fwd_rows(twopass.fwd_cols(t, plan, n1_log), plan, n1_log)
    np.testing.assert_array_equal(mm.to_host(strict),
                                  rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))
    if plan.word == 64:
        np.testing.assert_array_equal(mm.to_host(lazy),
                                      rm.fwd_ntt_harvey_lazy(a, p.q, plan.w, plan.w_con))
    back = twopass.inv_cols(twopass.inv_rows(strict, plan, n1_log), plan, n1_log)
    np.testing.assert_array_equal(mm.to_host(back), a)
    want = rm.inv_ntt_harvey(a, p.q, p.n_inv, plan.n_inv_con, plan.w_inv, plan.w_inv_con)
    got = twopass.inv_cols(twopass.inv_rows(t, plan, n1_log), plan, n1_log)
    np.testing.assert_array_equal(mm.to_host(got), want)


# -- the slice through the API ---------------------------------------------------

Q32 = JFIXTURES[0]  # the shape (2, 256) of the JAX package's own sixstep tests
Q64 = JNttParams.generate(62, 8)


def test_sixstep_variant_matches_jax_sixstep():
    """Word 32: strict and lazy forward equal JAX 'sixstep' (word-32 lazy
    representatives are the JAX word-32 path's); the inverse is exact."""
    p = from_fields(Q32)
    a = rand(p, (BATCH, p.n), 8)
    f = api.fwd_ntt(a, p, variant="sixstep", device="cpu")
    np.testing.assert_array_equal(f, jax_api.fwd_ntt(a, Q32, variant="sixstep"))
    np.testing.assert_array_equal(api.fwd_ntt(a, p, variant="sixstep", lazy=True, device="cpu"),
                                  jax_api.fwd_ntt(a, Q32, variant="sixstep", lazy=True))
    np.testing.assert_array_equal(api.inv_ntt(f, p, variant="sixstep", device="cpu"), a)


def test_sixstep_variant_word64_matches_refmodel():
    """Word 64: the JAX package's u64 path is bit-exact with refmodel, lazy
    representatives included, so refmodel stands in for it."""
    p = from_fields(Q64)
    plan = get_plan(p)
    a = rand(p, (BATCH, p.n), 9)
    a[0, :4] = p.q - 1
    np.testing.assert_array_equal(api.fwd_ntt(a, p, variant="sixstep", device="cpu"),
                                  rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))
    lazy = api.fwd_ntt(a, p, variant="sixstep", lazy=True, device="cpu")
    np.testing.assert_array_equal(lazy, rm.fwd_ntt_harvey_lazy(a, p.q, plan.w, plan.w_con))
    np.testing.assert_array_equal(
        api.inv_ntt(a, p, variant="sixstep", device="cpu"),
        rm.inv_ntt_harvey(a, p.q, p.n_inv, plan.n_inv_con, plan.w_inv, plan.w_inv_con))


@pytest.mark.parametrize("jp", [Q32, Q64, JFIXTURES[2], JFIXTURES[16]], ids=fixture_id)
def test_output_layout_equals_jax(jp):
    p = from_fields(jp)
    ours = api.output_layout("sixstep-unordered", p)
    np.testing.assert_array_equal(ours.perm,
                                  jax_api.output_layout("sixstep-unordered", jp).perm)
    np.testing.assert_array_equal(api.output_layout("sixstep", p).perm, np.arange(p.n))


def test_sixstep_unordered_matches_jax():
    """The transposed-layout forward equals JAX 'sixstep-unordered'; the
    layout fixes it to the standard order; the inverse reads it."""
    p = from_fields(Q32)
    a = rand(p, (BATCH, p.n), 10)
    u = api.fwd_ntt(a, p, variant="sixstep-unordered", device="cpu")
    np.testing.assert_array_equal(u, jax_api.fwd_ntt(a, Q32, variant="sixstep-unordered"))
    np.testing.assert_array_equal(api.output_layout("sixstep-unordered", p).fix(u),
                                  api.fwd_ntt(a, p, variant="sixstep", device="cpu"))
    np.testing.assert_array_equal(api.inv_ntt(u, p, variant="sixstep-unordered",
                                              device="cpu"), a)


@pytest.mark.parametrize("jp", [Q64, JFIXTURES[2]], ids=fixture_id)
def test_sixstep_unordered_word64_and_other_split(jp):
    p = from_fields(jp)
    a = rand(p, (BATCH, p.n), 11)
    u = api.fwd_ntt(a, p, variant="sixstep-unordered", lazy=True, device="cpu")
    lay = api.output_layout("sixstep-unordered", p)
    np.testing.assert_array_equal(lay.fix(u), api.fwd_ntt(a, p, variant="sixstep", lazy=True,
                                                           device="cpu"))
    strict = api.fwd_ntt(a, p, variant="sixstep-unordered", device="cpu")
    np.testing.assert_array_equal(api.inv_ntt(strict, p, variant="sixstep-unordered",
                                              device="cpu"), a)


def test_negacyclic_mul_sixstep_matches_jax():
    """The transposed-layout product equals the JAX package's fused one."""
    p = from_fields(Q32)
    a, b = rand(p, (BATCH, p.n), 12), rand(p, (BATCH, p.n), 13)
    np.testing.assert_array_equal(api.negacyclic_mul(a, b, p, variant="sixstep", device="cpu"),
                                  jax_api.negacyclic_mul(a, b, Q32))


@pytest.mark.parametrize("jp", [Q64, JFIXTURES[15]], ids=fixture_id)
def test_negacyclic_mul_sixstep_word64(jp):
    """Word 64: the sixstep product equals the pallas-fused one (held
    against JAX in test_torch_api) and, where N fits one block, the
    schoolbook product at sampled coefficients; 'auto' beyond one block is
    the sixstep product."""
    p = from_fields(jp)
    a, b = rand(p, (1, p.n), 14), rand(p, (1, p.n), 15)
    got = api.negacyclic_mul(a, b, p, variant="sixstep", device="cpu")
    for k in (0, 1, p.n // 2, p.n - 1):
        acc = sum(int(a[0, i]) * int(b[0, k - i]) for i in range(k + 1))
        acc -= sum(int(a[0, i]) * int(b[0, p.n + k - i]) for i in range(k + 1, p.n))
        assert int(got[0, k]) == acc % p.q
    if p.m <= fused.max_logn(64):
        np.testing.assert_array_equal(
            got, api.negacyclic_mul(a, b, p, variant="pallas-fused", device="cpu"))
    else:
        np.testing.assert_array_equal(got, api.negacyclic_mul(a, b, p, device="cpu"))


@pytest.mark.parametrize("i", [15, 16, 17, 18])
def test_fixture_beyond_one_block_through_auto(i):
    """The four reference fixtures the fused kernel cannot hold (m = 15 to 17,
    word 64) go through 'auto' to the two-pass path; equal to refmodel and
    a round trip, batch 1 on CPU tensors."""
    p = FIXTURES[i]
    plan = get_plan(p)
    assert plan.m > fused.max_logn(plan.word)
    assert api._pick(plan, "auto").name == "sixstep"
    assert api._pick(plan, "auto", inverse=True).name == "sixstep"
    a = mm.from_host(rand(p, (1, p.n), 16), p.q, "cpu")
    twopass_before = dict(twopass.LAUNCHES)
    f = api.fwd_ntt(a, p)
    np.testing.assert_array_equal(mm.to_host(f),
                                  rm.fwd_ntt_harvey(mm.to_host(a), p.q, plan.w, plan.w_con))
    assert torch.equal(api.inv_ntt(f, p), a)
    assert twopass.LAUNCHES == twopass_before  # the CPU route launches nothing
