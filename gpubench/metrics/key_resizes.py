"""Resizes of the static key buffer in the traced window, regrows and
shrinks together: the program's counters ``key_buffer.regrows`` and
``key_buffer.shrinks`` over the traced segments (``trace_steps`` over the
segment's steps)."""


def read(record):
    counters = record.get("program_counters")
    if counters is None or record.get("segments", 0) <= 0:
        return None
    resizes = counters.get("key_buffer.regrows", 0) + counters.get("key_buffer.shrinks", 0)
    return resizes / record["segments"]
