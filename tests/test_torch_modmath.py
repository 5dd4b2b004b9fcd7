"""The port's plain modular arithmetic (ntt_tpu_torch.modmath) against the
reference: ntt_tpu.refmodel and exact Python ints at word 64, the JAX
package's ntt_tpu.modmath at word 32.  Exact equality throughout: this is
integer arithmetic.  Edge values include t = 4q - 1 at the 62-bit q
2^62 - 2^16 + 1, where 4q - 1 has the sign bit of an int64 set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_tpu import modmath as jmm
from ntt_tpu import refmodel as rm
from ntt_tpu.params import FIXTURES, bench_params
from ntt_tpu_torch import modmath as mm

Q62 = bench_params(14, 62).q  # 2^62 - 2^16 + 1
QS64 = [
    Q62,
    FIXTURES[13].q,  # 51-bit
    FIXTURES[11].q,  # in [2^31, 2^32): mul_mod_q's conditional-subtract branch
    FIXTURES[10].q,  # in [2^30, 2^31): mul_mod_q's Barrett branch
]
QS32 = [FIXTURES[9].q, FIXTURES[8].q, FIXTURES[0].q]  # 29-, 28- and 13-bit
U64_MAX = (1 << 64) - 1


def qid(q):
    return f"q={q:#x}"


def t64(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint64).view(np.int64).copy())


def h64(t):
    return t.numpy().view(np.uint64)


def t32(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.uint32).view(np.int32))


def h32(t):
    return t.numpy().view(np.uint32)


def draw(rng, hi: int, edges=(), size=256):
    """Random values in [0, hi) followed by the edge values."""
    vals = rng.integers(0, hi, size=size, dtype=np.uint64)
    return np.concatenate([vals, np.array(edges, dtype=np.uint64)])


@pytest.mark.parametrize("q", [Q62, QS32[0]], ids=qid)
def test_host_roundtrip(q):
    rng = np.random.default_rng(1)
    hi = 4 * q if mm.uses_u32(q) else 1 << 64
    a = draw(rng, hi, edges=(0, hi - 1, q, 2 * q - 1))
    t = mm.from_host(a, q, "cpu")
    assert t.dtype == mm.dtype_for(q)
    np.testing.assert_array_equal(mm.to_host(t), a)


def test_mulhi64_matches_refmodel():
    rng = np.random.default_rng(2)
    edges = (0, 1, 1 << 63, U64_MAX, (1 << 32) - 1, 1 << 32)
    a = draw(rng, 1 << 64, edges)
    b = draw(rng, 1 << 64, edges[::-1])
    np.testing.assert_array_equal(h64(mm.mulhi64(t64(a), t64(b))), rm.mulhi64(a, b))


@pytest.mark.parametrize("q", QS64, ids=qid)
def test_shoup_mul_q2_matches_refmodel(q):
    rng = np.random.default_rng(3)
    t = draw(rng, 4 * q, edges=(0, 1, q - 1, 2 * q - 1, 2 * q, 4 * q - 1))
    w = rng.integers(0, q, size=t.size, dtype=np.uint64)
    w[-1] = q - 1
    wc = np.array([(int(x) << 64) // q for x in w], dtype=np.uint64)
    got = mm.shoup_mul_q2(t64(w), t64(wc), t64(t), q)
    np.testing.assert_array_equal(h64(got), rm.shoup_mul_q2(w, wc, t, q))
    assert (h64(got) < 2 * q).all()
    np.testing.assert_array_equal(h64(mm.shoup_mul_q(t64(w), t64(wc), t64(t), q)),
                                  rm.shoup_mul_q(w, wc, t, q))
    # a constant multiplicand (Python int), as in the fused final stage
    c = int(w[0])
    got_c = mm.shoup_mul_q2(c, (c << 64) // q, t64(t), q)
    np.testing.assert_array_equal(h64(got_c), rm.shoup_mul_q2(w[0], wc[0], t, q))


LADDER = [
    (name, f, q)
    for name, f in [("reduce_2q_to_q", 2), ("reduce_4q_to_2q", 4), ("reduce_4q_to_q", 4),
                    ("reduce_8q_to_4q", 8), ("reduce_8q_to_2q", 8), ("reduce_8q_to_q", 8)]
    for q in (Q62, FIXTURES[13].q)
    if f * q <= U64_MAX
]


@pytest.mark.parametrize("name,factor,q", LADDER,
                         ids=[f"{n}-{qid(q)}" for n, _, q in LADDER])
def test_reduce_ladder_matches_refmodel(name, factor, q):
    rng = np.random.default_rng(4)
    edges = [k * q + d for k in range(factor) for d in (0, q - 1)]
    v = draw(rng, factor * q, edges)
    got = getattr(mm, name)(t64(v), q)
    np.testing.assert_array_equal(h64(got), getattr(rm, name)(v, q))


@pytest.mark.parametrize("q", QS64, ids=qid)
def test_mul_mod_q_exact(q):
    rng = np.random.default_rng(5)
    a = draw(rng, q, edges=(0, 1, q - 1, q - 1))
    b = draw(rng, q, edges=(q - 1, 0, 1, q - 1))
    got = h64(mm.mul_mod_q(t64(a), t64(b), q))
    want = np.array([int(x) * int(y) % q for x, y in zip(a, b)], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_mul_mod_q_matches_jax_modmath():
    rng = np.random.default_rng(6)
    a = draw(rng, Q62, edges=(Q62 - 1,))
    b = draw(rng, Q62, edges=(Q62 - 1,))
    want = jmm.to_u64(jmm.mul_mod_q(jmm.from_u64(a), jmm.from_u64(b), Q62))
    np.testing.assert_array_equal(h64(mm.mul_mod_q(t64(a), t64(b), Q62)), want)


def _u32_case(name, q, rng):
    """(port result, JAX modmath result) of one word-32 function."""
    j32 = lambda x: jnp.asarray(np.asarray(x, dtype=np.uint64).astype(np.uint32))  # noqa: E731
    if name == "mulhi32":
        a, b = draw(rng, 1 << 32, (U64_MAX >> 32,)), draw(rng, 1 << 32, (U64_MAX >> 32,))
        return mm.mulhi32(t32(a), t32(b)), jmm.mulhi32(j32(a), j32(b))
    if name == "shoup_mul32_q2":
        t = draw(rng, 4 * q, edges=(0, q - 1, 2 * q, 4 * q - 1))
        w = rng.integers(0, q, size=t.size, dtype=np.uint64)
        wc = np.array([(int(x) << 32) // q for x in w], dtype=np.uint64)
        return (mm.shoup_mul32_q2(t32(w), t32(wc), t32(t), q),
                jmm.shoup_mul32_q2(j32(w), j32(wc), j32(t), q))
    if name == "cond_sub32":
        v = draw(rng, 4 * q, edges=(0, 2 * q - 1, 2 * q, 4 * q - 1))
        return mm.cond_sub32(t32(v), 2 * q), jmm.cond_sub32(j32(v), 2 * q)
    if name == "reduce32":
        v = draw(rng, 4 * q, edges=(0, q, 2 * q - 1, 3 * q, 4 * q - 1))
        return mm.reduce32(t32(v), q, 4), jmm.reduce32(j32(v), q, 4)
    if name == "barrett_reduce32":
        v = draw(rng, 1 << 32, edges=(0, q, (1 << 32) - 1))
        return mm.barrett_reduce32(t32(v), q), jmm.barrett_reduce32(j32(v), q)
    assert name == "mul_mod_q32"
    a, b = draw(rng, q, edges=(q - 1, 0)), draw(rng, q, edges=(q - 1, q - 1))
    return mm.mul_mod_q32(t32(a), t32(b), q), jmm.mul_mod_q32(j32(a), j32(b), q)


@pytest.mark.parametrize("q", QS32, ids=qid)
@pytest.mark.parametrize("name", ["mulhi32", "shoup_mul32_q2", "cond_sub32", "reduce32",
                                  "barrett_reduce32", "mul_mod_q32"])
def test_u32_ops_match_jax_modmath(name, q):
    got, want = _u32_case(name, q, np.random.default_rng(7))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(h32(got), np.asarray(want))


@pytest.mark.parametrize("q", [Q62, QS32[0]], ids=qid)
def test_bkw_final_with_wide_constant_matches_jax_elems(q):
    """The fused final stage's Shoup constant may be one bit wider than the
    word, and its top bit then adds t to the quotient.  No NttParams
    produce such a constant (tmp = n_inv * w_inv[1] lands below q), so the
    branch is driven with a lazy tmp in [q, 2q)."""
    from ntt_tpu.kernels import elems as jel
    from ntt_tpu_torch.kernels import elems as tel

    word = 32 if mm.uses_u32(q) else 64
    ours, theirs = (tel.U32Ops, jel.U32Ops) if word == 32 else (tel.U64Ops, jel.U64Ops)
    rng = np.random.default_rng(8)
    x = draw(rng, 2 * q, edges=(0, 2 * q - 1))
    y = draw(rng, 2 * q, edges=(2 * q - 1, 0))
    n_inv = pow(1 << 10, -1, q)
    n_inv_con = (n_inv << word) // q
    tmp = q + 12345
    con = (tmp << word) // q
    assert con >> word == 1
    to_t = t32 if word == 32 else t64
    got = ours.bkw_final(to_t(x), to_t(y), n_inv, n_inv_con, tmp, con, q)
    want = theirs.bkw_final(theirs.from_host(x), theirs.from_host(y), n_inv, n_inv_con,
                            tmp, con, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(mm.to_host(g), theirs.to_host(w))


def test_unsigned_compare_at_sign_bit():
    """A signed compare would keep 4q - 1 > 2^63 unreduced: the ladder
    must see it as the largest value."""
    v = t64([4 * Q62 - 1, 2 * Q62, (1 << 63) + 7])
    np.testing.assert_array_equal(
        h64(mm.reduce_4q_to_q(v, Q62)),
        np.array([Q62 - 1, 0, ((1 << 63) + 7) % Q62], dtype=np.uint64),
    )
