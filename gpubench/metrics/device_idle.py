"""Device idle share of the traced window: 1 - (union of the intervals in
which a kernel or copy ran on the card) / (the window's wall time)."""


def read(record):
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 1.0 - record["busy_s"] / record["window_s"]
