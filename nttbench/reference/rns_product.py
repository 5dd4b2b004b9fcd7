"""The plain reference of an RNS tower's products, in plain PyTorch.

Each channel is one prime q; a product in it is either the negacyclic
product of two polynomials in Z_q[X]/(X^N + 1) (``negacyclic``) or the
element-wise product mod q of two evaluation-form polynomials
(``pointwise_rep``).  Everything is worked out here from q alone: a
primitive 2N-th root of unity psi (psi^N = -1 mod q), its powers and
N^-1.  Nothing of the program under test is imported or read.

The negacyclic product twists both operands by psi^i, runs a cyclic
transform of length N with omega = psi^2 (Gentleman-Sande, natural order
in, bit-reversed out), multiplies point by point, runs the inverse
(Cooley-Tukey, bit-reversed in, natural out) and untwists by
psi^-i N^-1.  The order inside the transform domain cancels, so any
exact transform gives the same product.

Exact arithmetic on int64 tensors needs no 128-bit word: ``mulmod``
splits a into limbs of L = 63 - bits(q) bits, so that every partial
product limb * b < 2^L q < 2^63, and folds them from the top (Horner),
reducing with the exact integer remainder after each step.  Any q of up
to 62 bits works; the configuration here has 48-49 bits (4 limbs).

``mulmod_f64`` is the control: the same product through float64, whose
53-bit significand cannot hold a product of two residues of 27 bits or more.
"""

from __future__ import annotations

import torch


def mulmod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """(a * b) mod q for an int64 tensor a in [0, q) and b in [0, q), an
    int64 tensor (broadcastable) or an int."""
    limb = 63 - q.bit_length()
    if limb < 1:
        raise ValueError(f"q must have at most 62 bits, got {q.bit_length()}")
    shape = a.shape if isinstance(b, int) else torch.broadcast_shapes(a.shape, b.shape)
    acc = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for shift in range(((q.bit_length() - 1) // limb) * limb, -1, -limb):
        digit = (a >> shift) & ((1 << limb) - 1)
        acc = ((acc << limb) % q + (digit * b) % q) % q
    return acc


def mulmod_f64(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """The control's product: (a * b) mod q through float64."""
    return torch.fmod(a.double() * b.double(), float(q)).long()


def root_2n(q: int, n: int) -> int:
    """A primitive 2n-th root of unity mod the prime q (psi^n = -1)."""
    if (q - 1) % (2 * n):
        raise ValueError(f"2N = {2 * n} does not divide q - 1 for q = {q:#x}")
    for g in range(2, 1 << 16):
        psi = pow(g, (q - 1) // (2 * n), q)
        if pow(psi, n, q) == q - 1:
            return psi
    raise ValueError(f"no primitive {2 * n}-th root found for q = {q:#x}")


def powers(r: int, count: int, q: int, device) -> torch.Tensor:
    """[r^0, r^1, ..., r^(count-1)] mod q as an int64 tensor."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    while out.numel() < count:
        out = torch.cat([out, mulmod(out, pow(r, out.numel(), q), q)])
    return out[:count]


def _forward(x: torch.Tensor, w: torch.Tensor, q: int, mul) -> torch.Tensor:
    """Cyclic transform of each row, natural order in, bit-reversed out;
    w holds omega^j for j < N/2."""
    rows, n = x.shape
    h = n // 2
    while h >= 1:
        v = x.view(rows, n // (2 * h), 2, h)
        u, t = v[:, :, 0, :], v[:, :, 1, :]
        x = torch.stack([(u + t) % q, mul((u - t) % q, w[::n // (2 * h)], q)],
                        dim=2).reshape(rows, n)
        h //= 2
    return x


def _inverse(x: torch.Tensor, w_inv: torch.Tensor, q: int, mul) -> torch.Tensor:
    """The inverse of ``_forward`` without the 1/N: bit-reversed in, natural
    out; w_inv holds omega^-j for j < N/2."""
    rows, n = x.shape
    h = 1
    while h < n:
        v = x.view(rows, n // (2 * h), 2, h)
        u, t = v[:, :, 0, :], mul(v[:, :, 1, :], w_inv[::n // (2 * h)], q)
        x = torch.stack([(u + t) % q, (u - t) % q], dim=2).reshape(rows, n)
        h *= 2
    return x


def negacyclic(a: torch.Tensor, b: torch.Tensor, q: int, mul=mulmod) -> torch.Tensor:
    """a * b in Z_q[X]/(X^N + 1) for each row of the int64 (rows, N) a, b."""
    n, dev = a.shape[-1], a.device
    psi = root_2n(q, n)
    psi_inv = pow(psi, -1, q)
    twist = powers(psi, n, q, dev)
    untwist = mulmod(powers(psi_inv, n, q, dev), pow(n, -1, q), q)
    w = powers(psi * psi % q, max(n // 2, 1), q, dev)
    w_inv = powers(psi_inv * psi_inv % q, max(n // 2, 1), q, dev)
    fa = _forward(mul(a, twist, q), w, q, mul)
    fb = _forward(mul(b, twist, q), w, q, mul)
    return mul(_inverse(mul(fa, fb, q), w_inv, q, mul), untwist, q)


def pointwise_rep(a: torch.Tensor, b: torch.Tensor, q: int, mul=mulmod) -> torch.Tensor:
    """(a * b) mod q element-wise."""
    return mul(a, b, q)


ENTRIES = {"negacyclic": negacyclic, "pointwise_rep": pointwise_rep}


def product(entry: str, a: torch.Tensor, b: torch.Tensor, q: int, mul=mulmod) -> torch.Tensor:
    """The reference's answer for the tower entry ``entry`` on one channel."""
    return ENTRIES[entry](a.long(), b.long(), q, mul)


class Tower:
    """The reference in the program's place: the tower entries over lists
    of per-channel tensors, each channel's product computed here, with
    ``mul`` as its modular product (``mulmod_f64`` for the control)."""

    def __init__(self, moduli: list[int], mul=mulmod):
        self.moduli = list(moduli)
        self.mul = mul

    def negacyclic(self, ra: list, rb: list) -> list:
        return [negacyclic(a, b, q, self.mul) for a, b, q in zip(ra, rb, self.moduli)]

    def pointwise_rep(self, ra: list, rb: list) -> list:
        return [pointwise_rep(a, b, q, self.mul) for a, b, q in zip(ra, rb, self.moduli)]
