"""B3, the backward tile compositor (``composite_bwd_kernel``): its least
time at the card's peaks for the work of the traced views, counted by the
reference (``gpubench.counts.b3``), over its device time per step, in %."""
from gpubench import counts

KERNEL = "composite_bwd_kernel"


def read(record):
    seconds = sum(s for name, s in record["kernels"].items() if KERNEL in name)
    work = record["work"]
    if seconds <= 0 or not work or record["units"] <= 0:
        return None
    ops = sum(counts.b3(w)[0] for w in work) / len(work)
    nbytes = sum(counts.b3(w)[1] for w in work) / len(work)
    return counts.roofline_share(ops, nbytes, seconds / record["units"])
