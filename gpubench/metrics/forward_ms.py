"""Device milliseconds per step of the work launched inside the program's
``r3dgs.forward`` span: the render through the key buffer and the loss."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "forward")
