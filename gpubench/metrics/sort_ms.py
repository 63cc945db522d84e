"""Device milliseconds per unit (step or frame) of the radix-sort kernels
in the traced window, the sort of the (tile, depth) keys."""


def read(record):
    ms = sum(s for name, s in record["kernels"].items() if "radixsort" in name.lower()) * 1e3
    if ms <= 0 or record["units"] <= 0:
        return None
    return ms / record["units"]
