"""Milliseconds per step that the device stood idle in gaps that opened
while the host was inside the program's ``r3dgs.backward`` span: the
backward's dispatch, which leaves the card waiting."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "backward", "idle_s")
