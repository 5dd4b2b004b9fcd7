"""The port's RNS towers (ntt_tpu_torch.rns) on the CPU, bit for bit
against the JAX package's RnsTower / DeviceRnsTower at m = 6, q_bits
(29, 29, 30), as tests/test_rns.py builds them: the port's own prime scan
gives the JAX tower's moduli, and a tower built on the JAX tower's params
(carried across by params.from_fields) gives its encodings, transforms,
products and big-int products.  The JAX towers run once, through a
module-scoped fixture."""

import numpy as np
import pytest
import torch

from ntt_tpu import rns as jax_rns
from ntt_tpu_torch import rns
from ntt_tpu_torch.params import from_fields

M, Q_BITS = 6, (29, 29, 30)


def coeffs(seed, shape, bits):
    """Big-int (object) coefficients below 2^bits."""
    raw = np.random.default_rng(seed).integers(0, 1 << min(bits, 63), size=shape, dtype=np.uint64)
    return raw.astype(object)


@pytest.fixture(scope="module")
def jax_towers():
    """The JAX towers' outputs on one set of inputs: channels (3, 2, N)."""
    jt = jax_rns.RnsTower(m=M, q_bits=Q_BITS)
    jd = jax_rns.DeviceRnsTower(m=M, params=jt.params)
    x, y = coeffs(1, (2, jt.n), 63), coeffs(2, (2, jt.n), 63)
    ch_a, ch_b = jt.encode(x), jt.encode(y)
    big_a, big_b = coeffs(3, jt.n, 40), coeffs(4, jt.n, 40)
    # every transform through the device tower's handles, one compile of each
    # program a channel: strict outputs are the same through the host
    # tower's variants (the JAX package's own tests hold its towers equal)
    fa = jd.fwd_rep(jd.from_host(ch_a))
    out = {
        "fwd": jd.to_host(fa),
        "inv": jd.to_host(jd.inv_rep(fa)),
        "negacyclic_mul": jd.negacyclic_mul(ch_a, ch_b),
        "bigint": jd.negacyclic_mul_bigint(big_a, big_b),
    }
    return jt, (x, y, ch_a, ch_b, big_a, big_b), out


@pytest.fixture(scope="module")
def tower(jax_towers):
    jt = jax_towers[0]
    return rns.RnsTower(M, params=[from_fields(p) for p in jt.params], device="cpu")


def test_moduli_and_params_equal_jax(jax_towers):
    jt = jax_towers[0]
    own = rns.RnsTower(M, Q_BITS, device="cpu")
    assert own.moduli == jt.moduli and own.modulus_product == jt.modulus_product
    assert own.params == [from_fields(p) for p in jt.params]
    assert len(set(own.moduli)) == 3 and own.n == jt.n == 1 << M


def test_encode_decode_equal_jax(jax_towers, tower):
    jt, (x, y, ch_a, _, _, _), _ = jax_towers
    np.testing.assert_array_equal(tower.encode(x), ch_a)
    assert (tower.decode(ch_a) == jt.decode(ch_a)).all()
    assert (tower.decode(ch_a) == x % tower.modulus_product).all()
    native = np.random.default_rng(5).integers(0, 1 << 62, size=(2, tower.n), dtype=np.uint64)
    np.testing.assert_array_equal(tower.encode(native), tower.encode(native.astype(object)))


@pytest.mark.parametrize("op", ["fwd", "inv", "negacyclic_mul", "bigint"])
def test_host_tower_equals_jax(jax_towers, tower, op):
    _, (_, _, ch_a, ch_b, big_a, big_b), want = jax_towers
    got = {"fwd": lambda: tower.fwd(ch_a),
           "inv": lambda: tower.inv(want["fwd"]),
           "negacyclic_mul": lambda: tower.negacyclic_mul(ch_a, ch_b),
           "bigint": lambda: tower.negacyclic_mul_bigint(big_a, big_b)}[op]()
    if op == "bigint":
        assert (got == want[op]).all()
    else:
        np.testing.assert_array_equal(got, want[op])
    if op == "inv":
        np.testing.assert_array_equal(got, ch_a)


@pytest.mark.parametrize("tiling", [("auto", False), (1, False), (1, True)],
                         ids=["auto", "tile1", "tile1-pad"])
def test_device_tower_equals_jax(jax_towers, tiling):
    jt, (_, _, ch_a, ch_b, big_a, big_b), want = jax_towers
    dt = rns.DeviceRnsTower(M, params=[from_fields(p) for p in jt.params],
                            batch_tile=tiling[0], pad_to_tile=tiling[1], device="cpu")
    np.testing.assert_array_equal(dt.negacyclic_mul(ch_a, ch_b), want["negacyclic_mul"])
    ra, rb = dt.from_host(ch_a), dt.from_host(ch_b)
    assert all(isinstance(r, torch.Tensor) for r in ra)
    np.testing.assert_array_equal(
        dt.to_host(dt.inv_rep(dt.pointwise_rep(dt.fwd_rep(ra), dt.fwd_rep(rb)))),
        want["negacyclic_mul"])
    np.testing.assert_array_equal(dt.to_host(dt.inv_rep(dt.fwd_rep(ra))), ch_a)
    assert (dt.negacyclic_mul_bigint(big_a, big_b) == want["bigint"]).all()


def test_bigint_product_equals_schoolbook(tower, jax_towers):
    """The big-int product in Z_Q[X]/(X^N + 1), Q the moduli's product,
    against the schoolbook convolution over Python ints."""
    big_a, big_b = jax_towers[1][4:]
    n, big_q = tower.n, tower.modulus_product
    acc = [0] * n
    for i in range(n):
        for j in range(n):
            sign = 1 if i + j < n else -1
            acc[(i + j) % n] += sign * int(big_a[i]) * int(big_b[j])
    assert list(tower.negacyclic_mul_bigint(big_a, big_b)) == [c % big_q for c in acc]


def test_towers_default_to_the_card_and_never_fall_back():
    """The default device is the card: without one, a transform of numpy
    channels and the device tower's handles raise."""
    tw = rns.RnsTower(M, Q_BITS)
    ch = tw.encode(coeffs(6, (1, tw.n), 60))
    if torch.cuda.is_available():
        np.testing.assert_array_equal(tw.fwd(ch), rns.RnsTower(M, Q_BITS, device="cpu").fwd(ch))
        return
    with pytest.raises(RuntimeError, match="is_available"):
        tw.fwd(ch)
    with pytest.raises(RuntimeError, match="is_available"):
        rns.DeviceRnsTower(M, Q_BITS)
    with pytest.raises(ValueError, match="differ in m"):
        rns.RnsTower(M, params=[tw.params[0], rns.RnsTower(M + 1, (30,)).params[0]])
