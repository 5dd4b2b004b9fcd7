"""tables_s: seconds to make the tower's plans and put their tables on the
device (the benchmark's span around building the system under test)."""


def read(rec: dict) -> float | None:
    return rec["tables_s"]
