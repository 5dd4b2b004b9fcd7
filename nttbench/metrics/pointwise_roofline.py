"""pointwise_roofline: the least time of the traced steps' pointwise
products (``work.pointwise``) over the device time of the kernels of the
``pointwise`` group, in percent."""

from nttbench import work


def read(rec: dict) -> float | None:
    t, w = rec.get("trace"), rec["work"].get("pointwise")
    if not t or not w or not t["group_s"].get("pointwise"):
        return None
    return work.roofline_pct(w * t["steps"], t["group_s"]["pointwise"])
