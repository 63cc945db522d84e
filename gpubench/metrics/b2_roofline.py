"""B2, the statistics form of the forward tile compositor
(``composite_fwd_kernel<true>``): its least time at the card's peaks for the
work of a swept view, counted by the reference, over its device time per
launch, in %.

The work of a view is B1's (``gpubench.counts.b1``: 13 operations a scanned
pair; 40 B an entry, 8 B a tile and 24 B a pixel) and what the statistics
add in ``csrc/composite_fwd.cu``'s ``kWithStats`` branches: the four sums of
each contributing pair (its count, count x opacity, w = alpha T and the
incoming T; 4 operations) and the four statistics written per entry (16
B). The record's ``sweep_work`` holds the reference's count of the views it
compared (``reference.importance.view_stats``), whose mean is taken; the
launches are the program's counter of the kernel's wrapper, a captured
launch counted at each replay. None where either is missing or the kernel
took no device time."""
from gpubench import counts

KERNEL = "composite_fwd_kernel<true>"
LAUNCHES = "composite.composite_fwd_stats.launches"
OPS_STATS_CONTRIBUTING = 4
STATS_BYTES_ENTRY = 16


def b2(view_work: dict) -> tuple:
    """(operations, bytes) of one statistics compositor launch over a view."""
    ops, nbytes = counts.b1(view_work)
    return (ops + view_work["contributing_pairs"] * OPS_STATS_CONTRIBUTING,
            nbytes + view_work["entries"] * STATS_BYTES_ENTRY)


def read(record):
    seconds = sum(s for name, s in record["kernels"].items() if KERNEL in name)
    launches = (record.get("program_counters") or {}).get(LAUNCHES, 0)
    work = record.get("sweep_work")
    if seconds <= 0 or launches <= 0 or not work:
        return None
    ops = sum(b2(w)[0] for w in work) / len(work)
    nbytes = sum(b2(w)[1] for w in work) / len(work)
    return counts.roofline_share(ops, nbytes, seconds / launches)
