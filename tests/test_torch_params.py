"""The port's own parameters, twiddle tables and layouts (ntt_tpu_torch.params,
.twiddles, .kernels.layouts, .kernels.sixstep.default_split) against the
JAX package's originals: equal field for field and entry for entry."""

import dataclasses

import numpy as np
import pytest
import torch

from ntt_tpu import params as jparams
from ntt_tpu import twiddles as jtw
from ntt_tpu.kernels import layouts as jlayouts
from ntt_tpu.kernels import sixstep as jsixstep
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import params, twiddles
from ntt_tpu_torch.kernels import layouts, sixstep
from ntt_tpu_torch.plan import TABLE_NAMES, NttPlan

from conftest import fixture_id


def fields(p):
    return dataclasses.astuple(p)


@pytest.mark.parametrize("i", range(len(jparams.FIXTURES)))
def test_fixture_equals_jax(i):
    assert len(params.FIXTURES) == len(jparams.FIXTURES) == 19
    assert fields(params.FIXTURES[i]) == fields(jparams.FIXTURES[i])
    assert params.FIXTURES[i].n == jparams.FIXTURES[i].n


@pytest.mark.parametrize("width", range(11))
def test_bit_rev_idx_equals_jax(width):
    got = [twiddles.bit_rev_idx(i, width) for i in range(1 << width)]
    assert got == [jtw.bit_rev_idx(i, width) for i in range(1 << width)]
    assert got == twiddles.bit_rev_perm(1 << width).tolist()


def test_word_size_equals_jax():
    assert params.WORD_SIZE == jparams.WORD_SIZE == 64


@pytest.mark.parametrize("m", [14, 16, 20])
def test_bench_params_equal_jax(m):
    p = params.bench_params(m, 62)
    assert fields(p) == fields(jparams.bench_params(m, 62))
    p.validate()


def test_generate_equals_jax():
    assert fields(params.NttParams.generate(29, 16)) == fields(
        jparams.NttParams.generate(29, 16))
    assert params.NttParams.generate(29, 16).q == 0x1FFC0001
    assert fields(params.NttParams.make(0x10001, 5)) == fields(
        jparams.NttParams.make(0x10001, 5))
    with pytest.raises(ValueError):
        params.find_ntt_prime(13, 12)
    with pytest.raises(ValueError):
        params.NttParams.make(0x10001, 0)


@pytest.mark.parametrize("i", [0, 12, 18])
def test_from_fields_of_jax_params(i):
    jp = jparams.FIXTURES[i]
    p = params.from_fields(jp)
    assert isinstance(p, params.NttParams)
    assert p == params.FIXTURES[i]
    with pytest.raises(AttributeError):
        params.from_fields(object())


@pytest.mark.parametrize("p", [jparams.FIXTURES[1], jparams.FIXTURES[12]], ids=fixture_id)
def test_plan_tables_equal_jax_plan(p):
    jplan = jax_get_plan(p)
    ours = NttPlan(params.from_fields(p))
    for k in TABLE_NAMES:
        np.testing.assert_array_equal(getattr(ours, k), getattr(jplan, k), err_msg=k)


@pytest.mark.parametrize("n", [2, 8, 1 << 9])
def test_twiddle_builders_equal_jax(n):
    q = 0x7FFE0001  # 2^17 | q - 1
    w = params.primitive_2n_root(q, n.bit_length() - 1)
    np.testing.assert_array_equal(twiddles.bit_rev_perm(n), jtw.bit_rev_perm(n))
    tab = twiddles.calc_w(w, n, q)
    np.testing.assert_array_equal(tab, jtw.calc_w(w, n, q))
    np.testing.assert_array_equal(twiddles.calc_w_inv(pow(w, -1, q), n, q),
                                  jtw.calc_w_inv(pow(w, -1, q), n, q))
    for word in (32, 64):
        np.testing.assert_array_equal(twiddles.calc_w_con(tab, q, word),
                                      jtw.calc_w_con(tab, q, word))
        assert twiddles.calc_ninv_con(12345, q, word) == jtw.calc_ninv_con(12345, q, word)


@pytest.mark.parametrize("m", [1, 2, 5, 12])
def test_twiddle_builders_equal_jax_at_62_bits(m):
    """The vectorised builders (Shoup products of 62-bit words, quotient
    digits of the word-64 constants) at the bench q of 62 bits."""
    p = params.bench_params(m, 62)
    for w in (p.w, p.w_inv):
        tab = twiddles.calc_w(w, p.n, p.q)
        np.testing.assert_array_equal(tab, jtw.calc_w(w, p.n, p.q))
        np.testing.assert_array_equal(twiddles.calc_w_con(tab, p.q, 64),
                                      jtw.calc_w_con(tab, p.q, 64))


def test_twiddle_builders_reject_q_from_2_62():
    """The vectorised Shoup constants are exact for q < 2^62, the port's
    limit; a larger q raises instead of giving wrong constants."""
    q = (1 << 62) + 1
    with pytest.raises(ValueError, match="2\\^62"):
        twiddles.calc_w_con(np.array([1, 2], dtype=np.uint64), q, 64)
    with pytest.raises(ValueError, match="2\\^62"):
        params.primitive_2n_root(q, 1)


@pytest.mark.parametrize("m", range(1, 25))
def test_default_split_equals_jax(m):
    n = 1 << m
    for nlimb in (1, 2):
        assert sixstep.default_split(n, nlimb=nlimb) == jsixstep.default_split(n, nlimb=nlimb)
    assert sixstep.default_split(n, 64) == jsixstep.default_split(n, 64)
    assert sixstep.word_split(n, 32) == jsixstep.default_split(n, nlimb=1)
    assert sixstep.word_split(n, 64) == jsixstep.default_split(n, nlimb=2)


@pytest.mark.parametrize("m,n1_log", [(8, 1), (9, 4), (10, 3), (16, 8), (16, 10)])
def test_layouts_equal_jax(m, n1_log):
    n = 1 << m
    ours, theirs = layouts.transposed(n, n1_log), jlayouts.transposed(n, n1_log)
    assert ours.name == theirs.name
    np.testing.assert_array_equal(ours.perm, theirs.perm)
    np.testing.assert_array_equal(layouts.standard(n).perm, jlayouts.standard(n).perm)
    a = np.random.default_rng(m).integers(0, 1 << 40, size=(2, n), dtype=np.uint64)
    np.testing.assert_array_equal(ours.fix(a), theirs.fix(a))
    fixed = sixstep.fix_transposed_order(torch.from_numpy(a.view(np.int64)), n1_log)
    np.testing.assert_array_equal(fixed.numpy().view(np.uint64),
                                  jsixstep.fix_transposed_order(a, n1_log))
