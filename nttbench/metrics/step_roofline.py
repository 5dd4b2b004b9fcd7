"""step_roofline: the least time of all the work of the traced steps on
one card over the card-seconds of the traced window (its length times the
cell's cards), in percent: the whole step's share of the cell's roofline,
which bounds every kernel's share on the path."""

import functools
import operator

from nttbench import work


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["busy_s"] or not rec["work"]:
        return None
    total = functools.reduce(operator.add, rec["work"].values())
    return work.roofline_pct(total * t["steps"], rec["chips"] * t["window_s"])
