"""Device milliseconds per frame of the work launched inside the program's
``r3dgs.preprocess`` spans: the model's arrays and the projection."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "preprocess")
