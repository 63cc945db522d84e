"""Wall milliseconds per CUDA graph capture in the traced window: the
program's counters ``graph.capture_ms`` over ``graph.captures``."""


def read(record):
    counters = record.get("program_counters") or {}
    if counters.get("graph.captures", 0) <= 0:
        return None
    return counters["graph.capture_ms"] / counters["graph.captures"]
