"""device_idle_pct: the share of the traced window in which a card ran no
device operation, the mean over the cell's cards: 100 less ``busy_s``
(each card's union of its kernel, copy and fill intervals, the mean over
the cards) over the window (profiler)."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
