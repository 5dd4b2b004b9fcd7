"""setup_s: seconds from the process's start to the first measured step:
imports, the CUDA context, the kernel library (built on a checkout's
first run, loaded from its cache after), the tower's tables, the inputs
and the warm-up calls."""


def read(rec: dict) -> float | None:
    return rec["setup_s"]
