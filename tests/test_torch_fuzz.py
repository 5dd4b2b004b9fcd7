"""Randomized-instance fuzzing of the port on the CPU: the counterpart of
tests/test_fuzz.py.

Each run draws a few random (q_bits, m) NTT instances and their inputs from
one generator seeded by the OS, or by FUZZ_SEED to replay a run; the seed is
printed and is in every assertion message.  Each draw goes through the
port's API (plain PyTorch versions): fwd_ntt / inv_ntt through radix2 and
sixstep, radix4 and r4r2 where q_bits <= api.R4_MAX_Q_BITS (the port caps
radix-4 at 2^60, below the reference's faulty 61), radix4-w56 where
q_bits <= 52, against ntt_tpu.refmodel.fwd_ntt_harvey (numpy) on the JAX
plan's tables, with no jit call; the round trip exact; the lazy radix-2
output below 4q; negacyclic_mul at m5 against the direct O(N^2) product.

A (q_bits, m) pair with no NTT prime (13 bits at m9: no prime below 2^13 is
1 mod 2^10) is no instance: the draw takes the next pair from the same
generator until ``params.NttParams.generate`` gives one, so a run fails only
on a fault of the port, and a seed replays the same instances."""

import os

import numpy as np
import pytest

from ntt_tpu import params as jparams
from ntt_tpu import refmodel as rm
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import api
from ntt_tpu_torch.params import NttParams

SEED = int(os.environ.get("FUZZ_SEED", int.from_bytes(os.urandom(4), "little")))
print(f"\n[test_torch_fuzz] seed of this run = {SEED} (rerun: FUZZ_SEED={SEED})")
TAG = f"seed={SEED} (replay: FUZZ_SEED={SEED})"
MAX_DRAWS = 64


def draw(rng, bits, ms, tag=TAG):
    """(q_bits, m, params): q_bits from range(*bits), m from range(*ms),
    redrawn from the same generator until the pair has an NTT prime."""
    for _ in range(MAX_DRAWS):
        q_bits, m = int(rng.integers(*bits)), int(rng.integers(*ms))
        try:
            return q_bits, m, NttParams.generate(q_bits, m)
        except ValueError:
            continue
    raise AssertionError(f"no NTT prime in {MAX_DRAWS} draws of q_bits in {bits}, m in "
                         f"{ms}; {tag}")


_RNG = np.random.default_rng(SEED)
# a few instances a run: both word widths of the port, small m
CASES = [draw(_RNG, (13, 30), (6, 10)), draw(_RNG, (31, 61), (6, 10)),
         draw(_RNG, (62, 63), (6, 9))]


def fuzz_variants(q_bits: int) -> tuple[str, ...]:
    return ("radix2", "sixstep") + (
        ("radix4", "r4r2") if q_bits <= api.R4_MAX_Q_BITS else ()) + (
        ("radix4-w56",) if q_bits <= 52 else ())


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}bits-m{c[1]}")
def test_fuzz_instance(case):
    q_bits, m, p = case
    tag = f"q_bits={q_bits} m={m} q={p.q:#x} {TAG}"
    assert jparams.NttParams.generate(q_bits, m).q == p.q, tag
    jplan = jax_get_plan(jparams.NttParams.make(p.q, m))
    a = _RNG.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
    want = rm.fwd_ntt_harvey(a, p.q, jplan.w, jplan.w_con)
    for variant in fuzz_variants(q_bits):
        got = api.fwd_ntt(a, p, variant=variant, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=f"{variant} forward, {tag}")
        back = api.inv_ntt(got, p, variant=variant, device="cpu")
        np.testing.assert_array_equal(back, a, err_msg=f"{variant} round trip, {tag}")
    lazy = api.fwd_ntt(a, p, variant="radix2", lazy=True, device="cpu")
    assert int(lazy.max()) < 4 * p.q, f"lazy radix2 output not below 4q, {tag}"
    np.testing.assert_array_equal(lazy % np.uint64(p.q), want, err_msg=f"lazy radix2, {tag}")


def test_fuzz_polymul():
    q_bits, m, p = draw(_RNG, (20, 62), (5, 6))
    tag = f"q_bits={q_bits} m={m} q={p.q:#x} {TAG}"
    a = _RNG.integers(0, p.q, size=(p.n,), dtype=np.uint64)
    b = _RNG.integers(0, p.q, size=(p.n,), dtype=np.uint64)
    got = api.negacyclic_mul(a, b, p, device="cpu")
    acc = [0] * p.n
    for i in range(p.n):
        for j in range(p.n):
            k = (i + j) % p.n
            s = 1 if i + j < p.n else -1
            acc[k] += s * int(a[i]) * int(b[j])
    np.testing.assert_array_equal(got, np.array([v % p.q for v in acc], dtype=np.uint64),
                                  err_msg=tag)


def test_draw_takes_only_pairs_with_a_prime():
    """13 bits at m9 has no NTT prime: from ranges that hold only that pair
    the draw raises, naming the seed; where 14 bits may be drawn, it
    returns a 14-bit instance."""
    with pytest.raises(ValueError):
        NttParams.generate(13, 9)
    rng = np.random.default_rng(SEED)
    with pytest.raises(AssertionError, match=f"seed={SEED}"):
        draw(rng, (13, 14), (9, 10))
    q_bits, m, p = draw(rng, (13, 15), (9, 10))
    assert (q_bits, m) == (14, 9) and p.q.bit_length() == 14, TAG
