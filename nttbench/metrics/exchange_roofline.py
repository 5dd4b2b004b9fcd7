"""exchange_roofline: the least card-seconds of the bytes that the traced
steps' negacyclic products must move between cards
(``exchange_work.phase_bytes``, summed over the phases) over the device
seconds of the ``exchange`` group's operations, summed over the cards, in
percent.  None on one card, where nothing crosses, or where the group ran
nothing (the CPU).

S, the bytes of one operand a step, is N x word / 8 x rows x channels of
the cell's configuration and traffic, read here as the step's pointwise
work bytes over 3 (``work.pointwise`` counts two operands read and one
written).  The entry is the negacyclic product's, the one entry whose
cell lists this metric: the record that a reader gets holds no traffic.
The group holds every PyTorch copy kernel of the trace, in any cell
(``kernel_groups/exchange.json``)."""

from nttbench import exchange_work


def read(rec: dict) -> float | None:
    t, w = rec.get("trace"), rec["work"].get("pointwise")
    if not t or not w or rec["chips"] < 2 or not t["group_s"].get("exchange"):
        return None
    step = sum(exchange_work.phase_bytes("negacyclic", w.bytes // 3, rec["chips"]).values())
    return exchange_work.roofline_pct(step * t["steps"], t["group_s"]["exchange"])
