"""The fused transform's plain PyTorch version (the CPU route of
ntt_tpu_torch.kernels.fused) against the JAX package: its pallas-fused
variant in interpret mode, its six-step variant, and ntt_tpu.refmodel.
Exact equality throughout, lazy representatives included."""

import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import refmodel as rm
from ntt_tpu.params import FIXTURES, NttParams, bench_params
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import fused, sixstep
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.plan import get_plan

from conftest import FIXTURES_FAST, fixture_id

# Pallas in interpret mode is slow on the CPU: one fixture of each width, m = 8
# at word 32 and m = 5 at word 64 (the params of test_torch_api, so the JAX
# calls compile once).  The word-64 one runs the JAX two-launch inverse
# (A3 + A4).
FUSED_JAX = [FIXTURES[0], NttParams.generate(62, 5)]


def rand(p, batch, seed, hi=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.q if hi is None else hi, size=(batch, p.n), dtype=np.uint64)


def port_fwd(a, p, strict=True):
    return mm.to_host(fused.fwd_fused(mm.from_host(a, p.q, "cpu"), get_plan(p), strict))


def port_inv(a, p):
    return mm.to_host(fused.inv_fused(mm.from_host(a, p.q, "cpu"), get_plan(p)))


@pytest.mark.parametrize("p", FUSED_JAX, ids=fixture_id)
def test_fwd_fused_matches_jax_pallas_fused(p):
    a = rand(p, 2, seed=10)
    np.testing.assert_array_equal(port_fwd(a, p),
                                  jax_api.fwd_ntt(a, p, variant="pallas-fused"))


@pytest.mark.parametrize("p", FUSED_JAX, ids=fixture_id)
def test_inv_fused_matches_jax_pallas_fused(p):
    a = rand(p, 2, seed=11)
    f = port_fwd(a, p)
    got = port_inv(f, p)
    np.testing.assert_array_equal(got, jax_api.inv_ntt(f, p, variant="pallas-fused"))
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("p", FIXTURES_FAST, ids=fixture_id)
def test_fwd_fused_strict_matches_refmodel(p):
    plan = get_plan(p)
    a = rand(p, 2, seed=12)
    np.testing.assert_array_equal(port_fwd(a, p), rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))


@pytest.mark.parametrize("p", FIXTURES_FAST, ids=fixture_id)
def test_fwd_fused_lazy_matches_reference(p):
    """Word 64: refmodel's lazy Harvey representatives.  Word 32: the JAX
    six-step's (word-32 Shoup constants give other representatives)."""
    plan = get_plan(p)
    a = rand(p, 2, seed=13)
    got = port_fwd(a, p, strict=False)
    if plan.word == 64:
        want = rm.fwd_ntt_harvey_lazy(a, p.q, plan.w, plan.w_con)
    else:
        want = jax_api.fwd_ntt(a, p, variant="sixstep", lazy=True)
    np.testing.assert_array_equal(got, want)
    assert got.max() < 4 * p.q


@pytest.mark.parametrize("p", FIXTURES_FAST, ids=fixture_id)
def test_inv_fused_matches_refmodel(p):
    plan = get_plan(p)
    f = rand(p, 2, seed=14)
    want = rm.inv_ntt_harvey(f, p.q, p.n_inv, plan.n_inv_con, plan.w_inv, plan.w_inv_con)
    np.testing.assert_array_equal(port_inv(f, p), want)


@pytest.mark.parametrize("p", [FIXTURES[2], NttParams.generate(62, 8)], ids=fixture_id)
def test_any_split_gives_the_same_bits(p):
    plan, ops = get_plan(p), pick_ops(p.q)
    tabs = plan.device_tables("cpu")
    a = mm.from_host(rand(p, 2, seed=15), p.q, "cpu")
    outs = [sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, n1_log, strict=False)
            for n1_log in range(1, p.m + 1)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    f = mm.from_host(rand(p, 2, seed=16), p.q, "cpu")
    invs = [sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts, p.q,
                                n1_log) for n1_log in range(1, p.m + 1)]
    for o in invs[1:]:
        assert torch.equal(o, invs[0])


def test_lazy_inputs_up_to_4q_at_62_bits():
    """Forward inputs may be lazy (< 4q); at a 62-bit q, 4q - 1 has the
    int64 sign bit set."""
    p = FUSED_JAX[1]
    plan = get_plan(p)
    a = rand(p, 2, seed=17, hi=4 * p.q)
    a[0, :8] = 4 * p.q - 1
    np.testing.assert_array_equal(port_fwd(a, p, strict=False),
                                  rm.fwd_ntt_harvey_lazy(a, p.q, plan.w, plan.w_con))


EVERY_M = [(w, m) for w in (64, 32) for m in range(1, fused.max_logn(w) + 1)]


@pytest.mark.parametrize("word,m", EVERY_M, ids=[f"w{w}-m{m}" for w, m in EVERY_M])
def test_fused_plain_matches_refmodel_at_every_m(word, m):
    """K1 / K2's plain version at every m the kernels serve (the 62-bit bench
    q at word 64, a 29-bit q at word 32), one polynomial with inputs below
    4q: the strict forward and the inverse against refmodel, the lazy
    forward against refmodel's lazy representatives at word 64 (word-32
    Shoup constants give others) and below 4q, the round trip exact."""
    p = bench_params(m, 62) if word == 64 else NttParams.generate(29, m)
    plan = get_plan(p)
    assert plan.word == word
    a = rand(p, 1, seed=18 + m, hi=4 * p.q)
    f = port_fwd(a, p)
    np.testing.assert_array_equal(f, rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))
    lazy = port_fwd(a, p, strict=False)
    if word == 64:
        np.testing.assert_array_equal(lazy, rm.fwd_ntt_harvey_lazy(a, p.q, plan.w, plan.w_con))
    np.testing.assert_array_equal(lazy % p.q, f)
    assert lazy.max() < 4 * p.q
    back = port_inv(f, p)
    np.testing.assert_array_equal(
        back, rm.inv_ntt_harvey(f, p.q, p.n_inv, plan.n_inv_con, plan.w_inv, plan.w_inv_con))
    np.testing.assert_array_equal(back, a % p.q)
