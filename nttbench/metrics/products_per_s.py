"""products_per_s: residue-polynomial products completed in the measured
window over the window's seconds (host clock): every row of every channel
of every step counts one."""


def read(rec: dict) -> float | None:
    return rec["products"] / rec["window_s"]
