"""device_idle_pct: the share of the traced window in which no device
operation ran: 100 less the union of the kernel, copy and fill intervals
over the window (profiler)."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
