"""Entries the reference bins for the traced views over the program's
static key buffer K: the share of the buffer that holds work."""


def read(record):
    k = record["counters"].get("key_buffer")
    work = record["work"]
    if not k or not work:
        return None
    return sum(w["entries"] for w in work) / len(work) / k
