"""The work of the operations a step runs, and the roofline arithmetic.

The benchmark's own frozen copy of the bound that ``chip_smoke.py``
prints, rewritten to count the work of the operation rather than of the
launches that implement it, so that a share of the roofline reads the
same work whatever kernels run underneath:

  * a forward or inverse transform of ``rows`` polynomials of N words
    reads each polynomial once and writes it once, reads the twiddle
    words of an N-point transform once (N roots, each with its Shoup
    constant), and does N/2 log2 N butterflies of one modular product
    each; the inverse also scales by N^-1, folded into its last stage
    as N/2 more products;
  * a pointwise product reads two words and writes one per coefficient,
    and does one modular product per coefficient.

The least time of a piece of work is the larger of its bytes over the
memory rate and its 32-bit multiplies over the multiply rate.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, 700 W: HBM3 at 3.35 TB/s; 67 TFLOP/s of
# float32 are 128 fused multiply-adds an SM a clock, and Hopper issues
# 32-bit integer multiply-adds at half that rate.
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 67e12 / 4
# 32-bit multiplies of one modular product at each word (PERF.md section 3:
# a Shoup product is hi(w_con * t), w * t and Q * q; at word 64 a high half
# takes four partial products and a low half three).
MULS_PER_PRODUCT = {32: 3, 64: 10}
# The port's width rule (a Shoup product at word 32 needs 4q <= 2^32).
U32_MAX_Q_BITS = 30


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: int = 0
    muls: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.muls + other.muls)

    def __mul__(self, k: int) -> "Work":
        return Work(self.bytes * k, self.muls * k)


def word(q: int) -> int:
    """The machine word, 32 or 64 bits, in which the program holds residues mod q."""
    return 32 if q < 1 << U32_MAX_Q_BITS else 64


def transform(n: int, rows: int, word: int, inverse: bool = False) -> Work:
    """One forward (or inverse) transform of ``rows`` polynomials of n words."""
    size = word // 8
    log_n = n.bit_length() - 1
    products = n // 2 * log_n + (n // 2 if inverse else 0)
    return Work(bytes=2 * rows * n * size + 2 * n * size,
                muls=rows * products * MULS_PER_PRODUCT[word])


def pointwise(n: int, rows: int, word: int) -> Work:
    """One pointwise product of ``rows`` pairs of polynomials of n words."""
    return Work(bytes=3 * rows * n * (word // 8), muls=rows * n * MULS_PER_PRODUCT[word])


OPS = {"fwd": lambda n, rows, w: transform(n, rows, w),
       "inv": lambda n, rows, w: transform(n, rows, w, inverse=True),
       "pointwise": pointwise}


def step_work(moduli: list[int], n: int, rows: int, ops: list[dict]) -> dict[str, Work]:
    """{group: work} of one step: in every channel, each op of ``ops``
    ({"op", "count", "group"}) on ``rows`` polynomials."""
    out: dict[str, Work] = {}
    for spec in ops:
        for q in moduli:
            w = OPS[spec["op"]](n, rows, word(q)) * spec["count"]
            out[spec["group"]] = out.get(spec["group"], Work()) + w
    return out


def bound_s(work: Work) -> float:
    """The least time the card could take for ``work``, in seconds."""
    return max(work.bytes / HBM_BYTES_PER_S, work.muls / INT_MULS_PER_S)


def roofline_pct(work: Work, device_s: float) -> float:
    """The share, in percent, of the least time in the time taken."""
    return 100.0 * bound_s(work) / device_s
