"""ntt_roofline: the least time of the traced steps' transforms (the
operations' work, ``work.transform``) over the device time of the kernels
of the ``transforms`` group, in percent."""

from nttbench import work


def read(rec: dict) -> float | None:
    t, w = rec.get("trace"), rec["work"].get("transforms")
    if not t or not w or not t["group_s"].get("transforms"):
        return None
    return work.roofline_pct(w * t["steps"], t["group_s"]["transforms"])
