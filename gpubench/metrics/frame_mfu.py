"""The whole frame's share of the card's float32 peak: a frame's
operations as the benchmark counts them for the traced views
(``gpubench.counts.render_frame_ops``) over the untraced window's wall time
per frame, in %."""
from gpubench import counts


def read(record):
    work = record["work"]
    if not work or record.get("unit_s", 0) <= 0:
        return None
    ops = sum(counts.render_frame_ops(w) for w in work) / len(work)
    return 100.0 * ops / (record["unit_s"] * counts.PEAK_F32_OPS)
