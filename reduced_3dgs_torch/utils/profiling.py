"""Tracing and timing helpers (counterpart of
reduced_3dgs_tpu/utils/profiling.py).

``trace`` records a ``torch.profiler`` trace around a block and writes it
as a Chrome trace (chrome://tracing, Perfetto) into ``log_dir``; ``time_fn``
is a wall-clock timer that synchronises the card before reading the clock;
``annotate`` names a region in the trace.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block on the host and, when CUDA is available, on the
    card; yields ``log_dir``, where the Chrome trace is written on exit
    (``trace_<ns>.json``; the default directory is ``r3dgs_trace`` under
    the temporary directory):

        with profiling.trace("traces"):
            trainer.step(camera)
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "r3dgs_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Mean wall time of ``fn(*args, **kwargs)`` over ``iters`` calls after
    ``warmup``, the card synchronised before each clock reading:
    {"mean_s", "iters"}."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _synchronize()
    return {"mean_s": (time.perf_counter() - t0) / iters, "iters": iters}


def annotate(name: str):
    """A named region in the profiler's trace."""
    return torch.profiler.record_function(name)
