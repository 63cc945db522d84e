"""Kernel and graph launches the host made per training step in the traced
window (the profiler's runtime calls: cudaLaunchKernel, cudaGraphLaunch and
their kin); a replayed graph counts once, not by its kernels."""


def read(record):
    if record["units"] <= 0 or record["launches"] <= 0:
        return None
    return record["launches"] / record["units"]
