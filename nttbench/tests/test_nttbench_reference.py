"""The plain reference against a schoolbook product at small N, at the
prime widths of the configurations and at wider and narrower NTT primes
(55 and 45 bits, q = 1 mod 2^17)."""

from __future__ import annotations

import json
import random

import pytest
import torch

from nttbench.reference import rns_product as ref
from nttbench.tests.conftest import PKG


def _primes():
    out = [pytest.param(q, id=f"{q.bit_length()}bit") for q in (0x7fffffffba0001, 0x1fffffc20001)]
    for path in sorted((PKG / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        seen = set()
        for q, bits in zip(cfg["moduli"], cfg["moduli_bits"]):
            if bits not in seen:  # one prime of each width of each configuration
                seen.add(bits)
                out.append(pytest.param(int(q, 16), id=f"{path.stem}-{bits}bit"))
    return out


def schoolbook(a: list[int], b: list[int], q: int) -> list[int]:
    n = len(a)
    c = [0] * n
    for i in range(n):
        for j in range(n):
            if i + j < n:
                c[i + j] = (c[i + j] + a[i] * b[j]) % q
            else:
                c[i + j - n] = (c[i + j - n] - a[i] * b[j]) % q
    return c


@pytest.mark.parametrize("q", _primes())
@pytest.mark.parametrize("n", [2, 8, 32])
def test_negacyclic_matches_schoolbook(q, n):
    rng = random.Random(q ^ n)
    a = [[rng.randrange(q) for _ in range(n)] for _ in range(3)]
    b = [[rng.randrange(q) for _ in range(n)] for _ in range(3)]
    a[0] = [q - 1] * n  # the largest residues
    b[0] = [q - 1] * n
    got = ref.product("negacyclic", torch.tensor(a), torch.tensor(b), q)
    assert got.tolist() == [schoolbook(x, y, q) for x, y in zip(a, b)]


@pytest.mark.parametrize("q", _primes())
def test_pointwise_and_mulmod(q):
    rng = random.Random(q)
    a = [rng.randrange(q) for _ in range(256)] + [q - 1, 0, 1]
    b = [rng.randrange(q) for _ in range(256)] + [q - 1, q - 1, q - 1]
    got = ref.product("pointwise_rep", torch.tensor(a), torch.tensor(b), q)
    assert got.tolist() == [x * y % q for x, y in zip(a, b)]


@pytest.mark.parametrize("q", _primes())
def test_root_is_primitive(q):
    psi = ref.root_2n(q, 1 << 14)
    assert pow(psi, 1 << 14, q) == q - 1


@pytest.mark.parametrize("q", _primes())
def test_control_product_is_wrong(q):
    """The control's float64 product cannot hold a product of two residues
    of these widths: it differs from the exact one on most coefficients."""
    rng = random.Random(q + 1)
    a = torch.tensor([[rng.randrange(q) for _ in range(32)] for _ in range(4)])
    b = torch.tensor([[rng.randrange(q) for _ in range(32)] for _ in range(4)])
    exact = ref.product("negacyclic", a, b, q)
    control = ref.product("negacyclic", a, b, q, mul=ref.mulmod_f64)
    assert (exact != control).float().mean() > 0.9
