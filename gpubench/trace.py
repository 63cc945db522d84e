"""The traced window: ``torch.profiler`` around a stretch of the run, and
its reduction to what the per-layer readers take (device busy time, device
time by kernel name, host launches) and to the ``breakdown`` of the result
line (the device operations that took most time, and the longest idle gaps
named by what the host was doing).

Host spans of the benchmark's own are ``torch.profiler.record_function``
regions named ``gpubench.*`` (``span``); the idle gaps are named by the
innermost host operation running when the device fell idle.
"""
from __future__ import annotations

import bisect
import time

import torch

# Host runtime calls that put work on the device: kernels and graphs.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
TOP = 10


def span(name: str):
    """A named host region in the trace (``gpubench.<name>``)."""
    return torch.profiler.record_function(f"gpubench.{name}")


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def traced(fn, device) -> dict:
    """Run ``fn()`` under the profiler, the card synchronised at both ends,
    and reduce the trace: {"window_s", "busy_s", "kernels" {name: device
    s}, "launches", "spans" {name: [s, ...]}, "breakdown"}. On the CPU
    (the tests) only the host is traced."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with span("traced_window"):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return reduce_events(prof.events(), window_s)


def reduce_events(events, window_s: float) -> dict:
    device, host, launches, spans = [], [], 0, {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # A host region's shadow on the device timeline is no device work.
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    "gpubench."):
                device.append((start, end, e.name))
            continue
        if e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name.startswith("gpubench."):
            spans.setdefault(e.name[len("gpubench."):], []).append((end - start) * 1e-6)
        if not e.name.startswith("cuda") and not e.name.startswith("cu"):
            host.append((start, end, e.name))
    kernels = {}
    for s, e, name in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-6
    busy = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels, "launches": launches,
            "spans": spans,
            "breakdown": {"device_ops": [[name[:120], s] for name, s in top],
                          "idle_gaps": _idle_gaps(busy, host)}}


def _idle_gaps(busy, host):
    """The longest gaps between device work, each named by the innermost
    host operation that covers the gap's start."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:TOP]
    host = sorted(host)
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps:
        inner, inner_len = "host", float("inf")
        for s, e, name in host[:bisect.bisect_right(starts, at)]:
            if s <= at < e and e - s < inner_len and name != "gpubench.traced_window":
                inner, inner_len = name, e - s
        named.append([inner[:120], length * 1e-6])
    return named
