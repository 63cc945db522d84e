"""Milliseconds per frame that the device stood idle in gaps that opened
while the host was inside one of the program's ``r3dgs.sync.*`` spans, its
deliberate reads of the card."""


def read(record):
    spans = record.get("program_spans") or {}
    syncs = [v["idle_s"] for k, v in spans.items() if k.startswith("sync.")]
    if not syncs or record.get("units", 0) <= 0:
        return None
    return sum(syncs) * 1e3 / record["units"]
