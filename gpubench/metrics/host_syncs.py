"""The program's deliberate reads of the card per unit (step or frame) in
the traced window: its ``host_syncs`` counter (``profiling.counters()``)."""


def read(record):
    counters = record.get("program_counters")
    if counters is None or record.get("units", 0) <= 0:
        return None
    return counters.get("host_syncs", 0) / record["units"]
