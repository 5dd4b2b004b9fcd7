"""launch_host_us: the host's time of one kernel launch, the median
duration of the program's kernel-wrapper spans (``ntt_tpu_torch.kernel.*``)
in the traced window, in us: each span runs from the wrapper's entry
through its checks, tables, the output's allocation, the device context
and the stream lookup to the return of the launch call.

The spans are those that ``ntt_tpu_torch.trace`` recorded in this process
while the profiler ran, so the median takes in the profiler's warm-up
steps (2 of at least 12 steps).  None where the program records no spans
(a program without ``ntt_tpu_torch.trace``, a stand-in system) or where
the trace holds no kernel launch (the CPU's plain path launches nothing).
"""

import statistics
import sys

KERNEL = "ntt_tpu_torch.kernel."


def read(rec: dict) -> float | None:
    trace = sys.modules.get("ntt_tpu_torch.trace")
    if trace is None or not rec.get("trace") or not rec["trace"]["launches"]:
        return None
    us = [(s.end_ns - s.start_ns) / 1e3 for s in trace.spans()
          if s is not None and s.name.startswith(KERNEL)]
    return statistics.median(us) if us else None
