"""Device milliseconds per frame of the work launched inside the program's
``r3dgs.bin_and_sort`` span: the entries emitted and sorted, the tile
ranges (the sort alone is ``sort_ms``)."""
from gpubench import program_trace


def read(record):
    return program_trace.span_ms(record, "bin_and_sort")
