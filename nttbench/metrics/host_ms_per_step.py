"""host_ms_per_step: the host's time from issuing a step to the tower
entry's return, before the synchronise, summed over the measured window's
steps and divided by their number (ms)."""


def read(rec: dict) -> float | None:
    return 1e3 * sum(rec["host_issue_s"]) / len(rec["host_issue_s"])
