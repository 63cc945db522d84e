"""Device milliseconds per step of the work launched inside the program's
``r3dgs.backward`` span (``loss.backward()``; autograd's thread launches it
while the main thread waits in the span)."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "backward")
