"""Parameters of the negacyclic NTT over R_q[X]/(X^N + 1), N = 2^m.

The port's own copy of what it uses from ``ntt_tpu/params.py``: the
frozen ``NttParams`` (q, m, w, w_inv, n_inv) with the same field names,
the 19 reference fixtures, the deterministic prime and root generators
behind ``NttParams.generate``, ``bench_params`` and the RNS towers
(``find_ntt_primes``), the reference's ``WORD_SIZE``, and ``from_fields``,
the one way in for a parameter object of another package.  Host-side
Python with exact big-int arithmetic; nothing here runs on a device.
"""

from __future__ import annotations

import dataclasses
import functools

from ntt_tpu_torch import twiddles

WORD_SIZE = 64  # the reference's scalar word size (``ntt_tpu.params.WORD_SIZE``)


def is_probable_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    small_primes = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in small_primes:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    # deterministic for n < 3,317,044,064,679,887,385,961,981
    for a in small_primes:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_prime(bits: int, m: int, skip: int = 0) -> int:
    """Largest prime q < 2^bits with 2^(m+1) | q - 1 (so a 2N-th root
    exists); with skip > 0, the (skip+1)-th largest such prime."""
    return find_ntt_primes(bits, m, skip + 1)[skip]


def find_ntt_primes(bits: int, m: int, count: int) -> list[int]:
    """The ``count`` largest primes q < 2^bits with 2^(m+1) | q - 1, in
    descending order, from one scan (``ntt_tpu.params.find_ntt_primes``:
    the RNS towers take their moduli from it)."""
    two_n = 1 << (m + 1)
    k = ((1 << bits) - 1) // two_n
    out: list[int] = []
    while k > 0 and len(out) < count:
        q = k * two_n + 1
        if q < (1 << bits) and is_probable_prime(q):
            out.append(q)
        k -= 1
    if len(out) < count:
        raise ValueError(f"only {len(out)} NTT primes with bits={bits}, m={m}")
    return out


def find_solinas_ntt_prime(bits: int, m: int) -> int:
    """The prime q = 2^bits - 2^k + 1 of least k >= m + 1 (so 2^(m+1) |
    q - 1), the largest of that form (``ntt_tpu.params.find_solinas_ntt_prime``).
    Whether the switch's product takes it is ``modmath.solinas_form``'s
    call, which also needs 2k + 3 <= bits: 2^62 - 2^46 + 1, this function's
    answer at (62, 16), keeps the Shoup product.  Raises if no such prime
    exists."""
    for k in range(m + 1, bits - 1):
        q = (1 << bits) - (1 << k) + 1
        if is_probable_prime(q):
            return q
    raise ValueError(f"no Solinas NTT prime 2^{bits} - 2^k + 1 with k >= {m + 1}")


def primitive_2n_root(q: int, m: int) -> int:
    """The least primitive 2N-th root of unity mod q, N = 2^m: c =
    g^((q-1)/2N) for the first g of order divisible by 2N, then the least
    of the odd powers c^(2i+1), all of which are primitive 2N-th roots."""
    n = 1 << m
    two_n = 2 * n
    if q >= twiddles.Q_LIMIT:
        raise ValueError(f"q = {q:#x} is not below 2^62")
    if (q - 1) % two_n:
        raise ValueError(f"2N = {two_n} does not divide q - 1 for q = {q:#x}")
    exp = (q - 1) // two_n
    g = 2
    while True:
        c = pow(g, exp, q)
        if c != 1 and pow(c, n, q) == q - 1:
            break
        g += 1
        if g > 1000:
            raise ValueError("no generator found (q not prime?)")
    return int(twiddles.powers(c, two_n, q)[1::2].min())


@dataclasses.dataclass(frozen=True)
class NttParams:
    """One negacyclic NTT instance: N = 2^m, prime q, primitive 2N-th root
    w, its inverse and N^-1 mod q."""

    m: int
    q: int
    w: int
    w_inv: int
    n_inv: int

    @property
    def n(self) -> int:
        return 1 << self.m

    def validate(self) -> None:
        n, q, w = self.n, self.q, self.w
        if not is_probable_prime(q):
            raise ValueError(f"q={q:#x} is not prime")
        if pow(w, n, q) != q - 1:
            raise ValueError("w is not a primitive 2N-th root")
        if self.w_inv != pow(w, -1, q) or self.n_inv != pow(n, -1, q):
            raise ValueError("w_inv or n_inv is not the inverse mod q")

    @classmethod
    def make(cls, q: int, m: int, w: int | None = None) -> "NttParams":
        if m < 1:
            raise ValueError(f"m must be >= 1 (N = 2^m >= 2), got {m}")
        if w is None:
            w = primitive_2n_root(q, m)
        return cls(m=m, q=q, w=w, w_inv=pow(w, -1, q), n_inv=pow(1 << m, -1, q))

    @classmethod
    def generate(cls, q_bits: int, m: int, skip: int = 0) -> "NttParams":
        """An instance with a q_bits-bit modulus (skip > 0 selects the next
        distinct primes, see find_ntt_prime)."""
        return cls.make(find_ntt_prime(q_bits, m, skip), m)


def from_fields(obj) -> NttParams:
    """The port's NttParams of any object with attributes m, q, w, w_inv and
    n_inv, e.g. an ``ntt_tpu.params.NttParams``."""
    return NttParams(m=int(obj.m), q=int(obj.q), w=int(obj.w), w_inv=int(obj.w_inv),
                     n_inv=int(obj.n_inv))


def _fx(m: int, q: int, w: int, w_inv: int, n_inv: int) -> NttParams:
    return NttParams(m=m, q=q, w=w, w_inv=w_inv, n_inv=n_inv)


# The 19 reference fixtures: q from 13 to 51 bits, N = 2^8 .. 2^17.
FIXTURES: tuple[NttParams, ...] = (
    _fx(8, 0x1E01, 62, 1115, 7651),
    _fx(9, 0x10001, 431, 55045, 65409),
    _fx(10, 0x10001, 33, 1986, 65473),
    _fx(11, 0x10001, 21, 49933, 65505),
    _fx(12, 0x10001, 13, 15124, 65521),
    _fx(13, 0x10001, 15, 30584, 65529),
    _fx(14, 0x10001, 9, 7282, 65533),
    _fx(14, 0xC0001, 9, 174763, 786385),
    _fx(14, 0xFFF0001, 10360, 28987060, 268353541),
    _fx(14, 0x1FFC8001, 101907, 42191135, 536608783),
    _fx(14, 0x7FFE0001, 320878, 74168714, 2147221513),
    _fx(14, 0xFFF88001, 263641, 243522111, 4294213663),
    _fx(14, 0x7FFFFFFFE0001, 83051296654, 374947202223591, 2251662374600713),
    _fx(14, 0x80000001C0001, 72703961923, 153477749218715, 2251662376566673),
    _fx(15, 0x10001, 3, 21846, 65535),
    _fx(15, 0x80000001C0001, 82138512871, 535648572761016, 2251731096043465),
    _fx(16, 0x7FFE0001, 1859, 1579037640, 2147319811),
    _fx(16, 0x7FFFFFFFE0001, 29454831443, 520731633805630, 2251765453815811),
    _fx(17, 0x100180001, 79247, 4203069932, 4296507381),
)


@functools.lru_cache(maxsize=None)
def bench_params(m: int = 14, q_bits: int = 62, solinas: bool = False) -> NttParams:
    """The benchmark instance: N = 2^m with the largest q_bits-bit NTT
    prime (at m = 14: q = 2^62 - 2^16 + 1), or with solinas the prime of
    ``find_solinas_ntt_prime`` (the same q at the m14 headline)."""
    if solinas:
        p = NttParams.make(find_solinas_ntt_prime(q_bits, m), m)
    else:
        p = NttParams.generate(q_bits, m)
    p.validate()
    return p


@functools.lru_cache(maxsize=None)
def dist_params(m: int, q_bits: int = 30) -> NttParams:
    """The distributed six-step's instance (N = 2^20 .. 2^24 in the JAX
    package's cases): N = 2^m with the largest q_bits-bit NTT prime
    (``ntt_tpu.params.dist_params``)."""
    p = NttParams.generate(q_bits, m)
    p.validate()
    return p
