"""Launches of the hand-written kernels: made, counted, captured in CUDA
graphs and replayed.

``launch(wrapper, symbol, ...)`` calls a kernel's C launcher on the current
stream and counts the launch on ``wrapper``, a function registered with
``counted`` (it then holds ``.launches``, from 0). A launch made while the
current stream captures a CUDA graph runs only when the graph is replayed:
it goes to ``captured_launches`` instead, and whoever replays the graph adds
what its capture recorded with ``add_replayed_launches``.

``capture_graph`` is PyTorch's recipe for capturing work, and
``CameraGraph`` is work captured on a camera and replayed on others: the
training step's graph (``trainer.base.StepGraph``) and a sweep pass's
(``sweep.SweepGraph``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ...utils import profiling
from . import _build

# Launches recorded while a CUDA graph was being captured, by wrapper name.
captured_launches = {}
_wrappers = {}


def counted(wrapper):
    """Register ``wrapper``'s launch counts; returns it (a decorator)."""
    wrapper.launches = 0
    _wrappers[wrapper.__name__] = wrapper
    captured_launches[wrapper.__name__] = 0
    return wrapper


def wrappers() -> tuple:
    """The registered wrappers, in the order they registered."""
    return tuple(_wrappers.values())


def count_launch(wrapper):
    """Count one launch of ``wrapper`` (see the module docstring)."""
    if torch.cuda.is_current_stream_capturing():
        captured_launches[wrapper.__name__] += 1
    else:
        wrapper.launches += 1


def add_replayed_launches(tally: dict):
    """Count one replay of a graph whose capture recorded ``tally``
    (wrapper name -> launches) on each wrapper."""
    for name, n in tally.items():
        _wrappers[name].launches += n


def launch(wrapper, symbol: str, device, *args):
    """Call the launcher ``symbol`` (``_build.ARGTYPES``) on ``device``'s
    current stream, with ``args`` in its order and the stream last: a
    tensor goes as its address, None as NULL, any other value as it is.
    Raises RuntimeError on the CUDA error the launcher returns; else counts
    one launch of ``wrapper``. The library is looked up at each call."""
    lib = _build.load_library(_build.SOURCE_OF[symbol])
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                                     for a in args],
                                   torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    count_launch(wrapper)


def capture_graph(eager, captured, device):
    """PyTorch's recipe for capturing work: ``eager()`` runs once on a side
    stream, then ``captured()`` is captured into a new ``CUDAGraph``
    (``torch.cuda.graph`` empties the allocator's cache first), with the
    kernel launches the capture records. Returns (graph, eager()'s
    result, captured()'s result, the launch tally, the capture's wall
    seconds, the bytes of the card's memory the graph's pool holds after
    it). The pool's size walks the allocator's whole snapshot, so it is
    taken only while a profiler records, and is None otherwise."""
    with profiling.span("capture"):
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = eager()
        main.wait_stream(side)
        if torch.is_tensor(first):
            first.record_stream(main)
        before = dict(captured_launches)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = captured()
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - t0
    profiling.count("graph.captures")
    profiling.count("graph.capture_ms", capture_s * 1e3)
    tally = {name: n - before.get(name, 0) for name, n in captured_launches.items()}
    pool_bytes = pool_size(graph) if profiling.recording() else None
    return graph, first, out, tally, capture_s, pool_bytes


def pool_size(graph) -> int:
    """The bytes of the card's memory that ``graph``'s private pool holds,
    from a walk of the allocator's snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(graph.pool()))


class CameraGraph:
    """Work captured on ``camera`` (``capture_graph``) that reads the
    camera's tensor ``fields`` (those that are not None) from fixed clones
    in ``self.camera``: ``eager(self.camera)`` runs first, then
    ``captured(self.camera)`` is captured; ``first`` and ``out`` are their
    results. ``replay(camera)`` copies another camera's fields into the
    fixed ones, replays the graph and counts the launches its capture
    recorded. ``capture_s`` is the capture's wall seconds (the eager run
    excluded) and ``pool_bytes`` the size of the graph's memory pool (None
    unless a profiler recorded the capture)."""

    def __init__(self, camera, fields, eager, captured, device):
        self.fields = tuple(f for f in fields if getattr(camera, f) is not None)
        self.camera = dataclasses.replace(camera, **{f: getattr(camera, f).detach().clone()
                                                     for f in self.fields})
        self.graph, self.first, self.out, self.tally, self.capture_s, self.pool_bytes = \
            capture_graph(lambda: eager(self.camera), lambda: captured(self.camera), device)

    def replay(self, camera):
        for f in self.fields:
            getattr(self.camera, f).copy_(getattr(camera, f))
        self.graph.replay()
        add_replayed_launches(self.tally)
