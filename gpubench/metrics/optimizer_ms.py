"""Device milliseconds per step of the work launched inside the program's
``r3dgs.optimizer`` span: the cameras' and the model's Adam and the
densification statistics."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "optimizer")
