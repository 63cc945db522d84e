"""The program's own layers in a traced window: its ``r3dgs.*`` spans
(``reduced_3dgs_torch.utils.profiling.span``) and its counters
(``profiling.counters()``), reduced from the same profiler events as
``gpubench.trace``'s record.

``traced(fn, device)`` is ``gpubench.trace.traced`` with two more keys in
the record, both empty where the program has no spans or counters:

  program_spans     {name: {"count", "host_s", "device_s", "self_device_s",
                    "idle_s", "sync_calls"}} by span name without ``r3dgs.``.
                    A device operation belongs to every span whose host
                    interval holds the runtime call that launched it (linked
                    by the profiler's correlation id), on any thread: autograd
                    launches the backward's kernels from its own thread while
                    the main thread waits inside ``r3dgs.backward``.
                    ``device_s`` sums its operations' device time once per
                    name, ``self_device_s`` only in the innermost span. An idle
                    gap of the device belongs to the spans that hold the
                    moment it opens (``idle_s``); ``sync_calls`` counts the
                    synchronising runtime calls made inside the span.
  program_counters  the change of ``profiling.counters()`` across ``fn``, or
                    None where the program has no counters.

The per-layer readers ``metrics/<stem>.py`` of the program's layers read
these keys and return None where they are missing. ``main`` runs a cell
traced so, on the card, and prints the cell's traced result line with
those readers' metrics, the spans and the counters:

    python3 -m gpubench.program_trace --workload <cell> --seed <n> --seconds <s>
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import sys
import time

import torch

from gpubench import trace

PREFIX = "r3dgs."
# Runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
              "cuMemcpy")
# The program's per-layer metrics of each cell, read by metrics/<stem>.py.
METRICS = {
    "truck-flagship.steady": ["host_syncs.train"],
    "truck-camera.steady": ["forward_ms.camera", "backward_ms.camera", "optimizer_ms.camera",
                            "backward_idle.camera", "host_syncs.camera"],
    "truck-flagship.render": ["preprocess_ms.render", "binning_ms.render",
                              "composite_ms.render", "sync_idle.render", "host_syncs.render"],
}


def counter_snapshot():
    """``profiling.counters()`` of the program, or None where it has none."""
    try:
        from reduced_3dgs_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else dict(read())


def counter_delta(before, after):
    if before is None or after is None:
        return None
    return {k: after.get(k, 0) - before.get(k, 0) for k in sorted(set(before) | set(after))}


def _holders(spans, times):
    """For each time of the sorted ``times``, the spans (start, end, name)
    whose [start, end) holds it, by a sweep over the spans sorted by start."""
    order = sorted(spans)
    out, active, ends, i = [], [], [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            heapq.heappush(ends, (order[i][1], i))
            active.append(i)
            i += 1
        while ends and ends[0][0] <= t:
            active.remove(heapq.heappop(ends)[1])
        out.append([order[j] for j in active])
    return out


def _entry():
    return {"count": 0, "host_s": 0.0, "device_s": 0.0, "self_device_s": 0.0, "idle_s": 0.0,
            "sync_calls": 0}


def program_spans(events) -> dict:
    """The ``program_spans`` record key from the profiler's events (see the
    module docstring)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, launched, device, syncs = [], {}, [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    ("gpubench.", PREFIX)):
                device.append((start, end, e.id))
            continue
        if e.name.startswith(PREFIX):
            spans.append((start, end, e.name[len(PREFIX):]))
        elif e.name.startswith("cu"):
            launched[e.id] = start
            if e.name in SYNC_CALLS:
                syncs.append(start)
    out = {}
    for start, end, name in spans:
        entry = out.setdefault(name, _entry())
        entry["count"] += 1
        entry["host_s"] += (end - start) * 1e-6
    if not spans:
        return out

    def innermost(holders):
        return min(holders, key=lambda s: s[1] - s[0])[2]

    ops = sorted((launched[c], e - s) for s, e, c in device if c in launched)
    for (_, dur), holders in zip(ops, _holders(spans, [t for t, _ in ops])):
        for name in {h[2] for h in holders}:
            out[name]["device_s"] += dur * 1e-6
        if holders:
            out[innermost(holders)]["self_device_s"] += dur * 1e-6
    busy = trace._union([(s, e) for s, e, _ in device])
    gaps = [(busy[i][1], busy[i + 1][0] - busy[i][1]) for i in range(len(busy) - 1)]
    for (_, length), holders in zip(gaps, _holders(spans, [at for at, _ in gaps])):
        for name in {h[2] for h in holders}:
            out[name]["idle_s"] += length * 1e-6
    syncs.sort()
    for holders in _holders(spans, syncs):
        for name in {h[2] for h in holders}:
            out[name]["sync_calls"] += 1
    return out


def traced(fn, device) -> dict:
    """``gpubench.trace.traced`` with ``program_spans`` and
    ``program_counters`` in the record."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    before = counter_snapshot()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with trace.span("traced_window"):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    after = counter_snapshot()
    events = prof.events()
    record = trace.reduce_events(events, window_s)
    record.update(program_spans=program_spans(events),
                  program_counters=counter_delta(before, after))
    return record


def span_ms(record, name: str, key: str = "device_s"):
    """Milliseconds per unit of ``key`` of the span ``name`` in the record,
    or None where the record holds no such span."""
    entry = (record.get("program_spans") or {}).get(name)
    if entry is None or record.get("units", 0) <= 0:
        return None
    return entry[key] * 1e3 / record["units"]


@contextlib.contextmanager
def program_record():
    """Inside the block ``gpubench.trace.traced`` is this module's
    ``traced``; yields the list of the records it made."""
    records, original = [], trace.traced

    def keeping(fn, device):
        records.append(traced(fn, device))
        return records[-1]

    trace.traced = keeping
    try:
        yield records
    finally:
        trace.traced = original


def main(argv=None) -> int:
    from gpubench import run
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    run.cache_environment()
    with program_record() as records:
        result = run.execute(args.workload, args.seed, args.seconds, True, args.device)
    record = records[-1]
    metrics = {}
    for name in METRICS.get(args.workload, []):
        value = run.metric_reader(name)(record)
        metrics[name] = value
    spans = record["program_spans"]
    units = record["units"]
    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
            "metrics": result["metrics"], "program_metrics": metrics,
            "device": result["device"], "units": units,
            "busy_ms_per_unit": record["busy_s"] * 1e3 / units,
            "window_ms_per_unit": record["window_s"] * 1e3 / units,
            "program_spans": spans, "program_counters": record["program_counters"],
            "breakdown": result["breakdown"],
            "device_ops_named_r3dgs": [n for n in record["kernels"] if n.startswith(PREFIX)]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
