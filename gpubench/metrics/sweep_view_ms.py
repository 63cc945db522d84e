"""Device milliseconds per swept view of the work launched inside the
program's ``r3dgs.sweep_pass`` span (``ops.rasterize.sweep.static_sweep``:
the model's arrays, preprocess, binning, the statistics gather, B2 and the
per-Gaussian sums of every view, the first eager, the rest replayed), over
the program's counter ``sweep.views``; None where the program has neither,
or nothing ran on the card."""


def read(record):
    entry = (record.get("program_spans") or {}).get("sweep_pass")
    views = (record.get("program_counters") or {}).get("sweep.views", 0)
    if not entry or views <= 0 or entry["device_s"] <= 0:
        return None
    return entry["device_s"] * 1e3 / views
