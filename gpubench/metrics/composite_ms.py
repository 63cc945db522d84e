"""Device milliseconds per frame of the work launched inside the program's
``r3dgs.composite`` span: field packing, the gather, B1 and the stitched
images."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "composite")
