"""Device milliseconds per densify event of the work launched inside the
program's ``r3dgs.redundancy`` span (the mercy prune's pixel size over the
views, intersection, minimum and policy), over the count of
``r3dgs.event.densify``."""


def read(record):
    spans = record.get("program_spans") or {}
    metric, event = spans.get("redundancy"), spans.get("event.densify")
    if not metric or not event or event["count"] <= 0:
        return None
    return metric["device_s"] * 1e3 / event["count"]
