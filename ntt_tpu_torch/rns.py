"""RNS (residue number system) towers: k NTT primes sharing one ring
degree N = 2^m, the form in which HE schemes (BGV, BFV, CKKS) hold a
ciphertext's big-integer coefficients.

The counterpart of ``ntt_tpu/rns.py``:

  * ``RnsTower``: distinct NTT primes of the requested widths
    (``params.find_ntt_primes``), CRT encode / decode of big-int
    coefficients on the host with exact Python ints, and fwd / inv /
    negacyclic_mul of every residue channel through the port's API on
    ``device``;
  * ``DeviceRnsTower``: one ``api.DeviceNtt`` a channel, whose per-channel
    ops take and return lists of tensors on the device, so a chain of
    products moves to and from the host once.

Both run on the card by default (``device="cuda"``); numpy input with that
default raises on a machine without one.
"""

from __future__ import annotations

import numpy as np

from ntt_tpu_torch import api
from ntt_tpu_torch.params import NttParams, find_ntt_primes


class RnsTower:
    """A tower of k NTT-friendly primes sharing one ring degree N = 2^m."""

    def __init__(self, m: int, q_bits=(30, 30, 30), params=None, device="cuda"):
        if params is not None:
            self.params = list(params)
            if len({p.m for p in self.params}) != 1:
                raise ValueError("the tower's params differ in m")
            self.m = self.params[0].m
        else:
            # one descending prime scan a distinct width, not a channel
            counts: dict[int, int] = {}
            for bits in q_bits:
                counts[bits] = counts.get(bits, 0) + 1
            pools = {bits: iter(find_ntt_primes(bits, m, k)) for bits, k in counts.items()}
            self.params = [NttParams.make(next(pools[bits]), m) for bits in q_bits]
            self.m = m
        self.device = device
        self.n = 1 << self.m
        self.moduli = [p.q for p in self.params]
        self.modulus_product = 1
        for q in self.moduli:
            self.modulus_product *= q

    # -- CRT encode / decode on the host --------------------------------------

    def encode(self, coeffs) -> np.ndarray:
        """Big-int (object) or uint64 coefficients (..., N) -> residue
        channels (k, ..., N) uint64."""
        arr = np.asarray(coeffs)
        out = np.empty((len(self.moduli),) + arr.shape, dtype=np.uint64)
        for i, q in enumerate(self.moduli):
            if arr.dtype == object:
                out[i] = (arr % q).astype(np.uint64)
            else:
                out[i] = arr.astype(np.uint64) % np.uint64(q)
        return out

    def decode(self, channels: np.ndarray) -> np.ndarray:
        """Residue channels (k, ..., N) -> big-int coefficients (..., N)
        (object dtype): exact CRT reconstruction mod the moduli's product."""
        big_q = self.modulus_product
        acc = np.zeros(channels.shape[1:], dtype=object)
        for i, q in enumerate(self.moduli):
            big_qi = big_q // q
            lift = big_qi * pow(big_qi % q, -1, q) % big_q
            acc = (acc + channels[i].astype(object) * lift) % big_q
        return acc

    # -- per-channel transforms on the device ----------------------------------

    def fwd(self, channels: np.ndarray, variant: str = "auto") -> np.ndarray:
        """Forward NTT of every residue channel; channels (k, ..., N)."""
        return np.stack([api.fwd_ntt(channels[i], p, variant=variant, device=self.device)
                         for i, p in enumerate(self.params)])

    def inv(self, channels: np.ndarray, variant: str = "auto") -> np.ndarray:
        return np.stack([api.inv_ntt(channels[i], p, variant=variant, device=self.device)
                         for i, p in enumerate(self.params)])

    def negacyclic_mul(self, ch_a: np.ndarray, ch_b: np.ndarray) -> np.ndarray:
        """Channel-wise polynomial product (the core of an HE ciphertext
        multiply)."""
        return np.stack([api.negacyclic_mul(ch_a[i], ch_b[i], p, device=self.device)
                         for i, p in enumerate(self.params)])

    def negacyclic_mul_bigint(self, a, b) -> np.ndarray:
        """Big-int polynomials -> encode -> channel products -> decode: the
        product in Z_Q[X]/(X^N + 1), Q the moduli's product (exact over the
        integers while the product's coefficients stay below Q)."""
        return self.decode(self.negacyclic_mul(self.encode(a), self.encode(b)))


class DeviceRnsTower(RnsTower):
    """A tower whose channel ops run on device tensors: one
    ``api.DeviceNtt`` a channel, a list of k tensors for the k channels.
    The host-facing RnsTower methods work as well; ``negacyclic_mul`` goes
    through the handles, one copy each way for the whole tower.

    >>> tw = DeviceRnsTower(14, (30, 30, 30))
    >>> ra, rb = tw.from_host(tw.encode(a)), tw.from_host(tw.encode(b))
    >>> prod = tw.decode(tw.to_host(tw.negacyclic(ra, rb)))
    """

    def __init__(self, m: int, q_bits=(30, 30, 30), params=None, lazy: bool = False,
                 batch_tile: "int | str | None" = "auto", pad_to_tile: bool = False,
                 device="cuda"):
        super().__init__(m, q_bits, params, device)
        self.ctxs = [api.DeviceNtt(p, lazy=lazy, batch_tile=batch_tile,
                                   pad_to_tile=pad_to_tile, device=device)
                     for p in self.params]

    # host <-> device: channels (k, ..., N) uint64 <-> a list of k tensors
    def from_host(self, channels: np.ndarray) -> list:
        return [ctx.from_host(channels[i]) for i, ctx in enumerate(self.ctxs)]

    def to_host(self, reps: list) -> np.ndarray:
        return np.stack([ctx.to_host(r) for ctx, r in zip(self.ctxs, reps)])

    # device ops (list of tensors -> list of tensors)
    def fwd_rep(self, reps: list) -> list:
        return [ctx.fwd(r) for ctx, r in zip(self.ctxs, reps)]

    def inv_rep(self, reps: list) -> list:
        return [ctx.inv(r) for ctx, r in zip(self.ctxs, reps)]

    def pointwise_rep(self, ra: list, rb: list) -> list:
        return [ctx.pointwise(a, b) for ctx, a, b in zip(self.ctxs, ra, rb)]

    def negacyclic(self, ra: list, rb: list) -> list:
        """Channel-wise product, every step on the device."""
        return [ctx.negacyclic(a, b) for ctx, a, b in zip(self.ctxs, ra, rb)]

    def negacyclic_mul(self, ch_a: np.ndarray, ch_b: np.ndarray) -> np.ndarray:
        return self.to_host(self.negacyclic(self.from_host(ch_a), self.from_host(ch_b)))
