"""The bytes that the distributed six-step's exchange must move between
cards, and their least time: the benchmark's frozen count, beside
``work.py``, counted for the operation and never for the launches or
copies that implement it.

With S the bytes of one operand (one polynomial of N words a row and a
channel) on D cards, one shard a card, and the operands and the result
whole on the home card (the port's global-rep contract), each phase sends
from one card to another the (D - 1) / D of its operands that the home
card's shard does not hold:

  * the scatter of each input operand onto the shards;
  * each all-to-all of the six-step's transpose: every shard keeps one
    block of D and sends the others;
  * the gather of the result onto the home card.

A forward or an inverse transform moves one operand in each phase; the
negacyclic product scatters two, runs three all-to-alls (one a forward,
one for the inverse) and gathers one: 6 S (D - 1) / D, 4.5 S at D = 4.

The least time of B bytes between cards is B over one card's NVLink rate
in one direction, in card-seconds: every byte leaves one card.  The
layout copies that stay on one card count no least time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: NVLink 4 at 900 GB/s a card, both ways
# together, so 450 GB/s out of a card.
NVLINK_BYTES_PER_S = 450e9

# Operands each phase moves, by the entry that runs it.
PHASES = {
    "fwd": {"scatter": 1, "all_to_all": 1, "gather": 1},
    "inv": {"scatter": 1, "all_to_all": 1, "gather": 1},
    "negacyclic": {"scatter": 2, "all_to_all": 3, "gather": 1},
}


def phase_bytes(entry: str, operand_bytes: int, cards: int) -> dict[str, int]:
    """{phase: bytes sent between cards} of one call of ``entry`` on
    operands of ``operand_bytes`` bytes, sharded over ``cards`` cards."""
    return {phase: k * operand_bytes * (cards - 1) // cards
            for phase, k in PHASES[entry].items()}


def bound_s(nbytes: int) -> float:
    """The least card-seconds in which ``nbytes`` cross between cards."""
    return nbytes / NVLINK_BYTES_PER_S


def roofline_pct(nbytes: int, device_s: float) -> float:
    """The share, in percent, of the least card-seconds in the device
    seconds taken."""
    return 100.0 * bound_s(nbytes) / device_s
