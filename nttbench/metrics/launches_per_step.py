"""launches_per_step: kernel launches on the device a step, the median
over the traced window's steps (profiler)."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["launches"]:
        return None
    return t["launches"]
