"""Device milliseconds per densify event of the work launched inside the
program's ``r3dgs.knn`` span (the mercy prune's neighbour search,
``ops.knn.knn``), over the count of ``r3dgs.event.densify``."""


def read(record):
    spans = record.get("program_spans") or {}
    knn, event = spans.get("knn"), spans.get("event.densify")
    if not knn or not event or event["count"] <= 0:
        return None
    return knn["device_s"] * 1e3 / event["count"]
