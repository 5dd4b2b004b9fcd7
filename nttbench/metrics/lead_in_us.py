"""lead_in_us: how long a step's device waits for its first kernel while
the host issues it: the median, over the tower calls of the traced window,
of the time from the tower call's span (``ntt_tpu_torch.tower.*``, the
root of its request) starting to the end of its first kernel-wrapper span
(``ntt_tpu_torch.kernel.*``: the return of its first launch call), in us.
With one step in flight, every step pays it after the last one's
synchronise.

The spans are those that ``ntt_tpu_torch.trace`` recorded in this process
while the profiler ran, so the median takes in the profiler's warm-up
steps (2 of at least 12 steps).  None where the program records no spans
(a program without ``ntt_tpu_torch.trace``, a stand-in system) or where
the trace holds no kernel launch (the CPU's plain path launches nothing).
"""

import statistics
import sys

TOWER, KERNEL = "ntt_tpu_torch.tower.", "ntt_tpu_torch.kernel."


def read(rec: dict) -> float | None:
    trace = sys.modules.get("ntt_tpu_torch.trace")
    if trace is None or not rec.get("trace") or not rec["trace"]["launches"]:
        return None
    spans = trace.spans()
    first_end: dict[int, int] = {}  # root index -> end of its first kernel span
    for s in spans:
        if s is not None and s.name.startswith(KERNEL) and s.root not in first_end:
            first_end[s.root] = s.end_ns
    us = [(first_end[i] - s.start_ns) / 1e3 for i, s in enumerate(spans)
          if s is not None and s.parent < 0 and s.name.startswith(TOWER) and i in first_end]
    return statistics.median(us) if us else None
