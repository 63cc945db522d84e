"""Host milliseconds per event inside the program's ``r3dgs.event.densify``
span: the densifier chain computed and applied (split and clone, the
opacity and mercy prunes, the new state), over the span's count."""


def read(record):
    entry = (record.get("program_spans") or {}).get("event.densify")
    if not entry or entry["count"] <= 0:
        return None
    return entry["host_s"] * 1e3 / entry["count"]
