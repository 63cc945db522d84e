"""Tracing, counting and timing helpers (counterpart of
reduced_3dgs_tpu/utils/profiling.py).

``trace`` records a ``torch.profiler`` trace around a block and writes it
as a Chrome trace (chrome://tracing, Perfetto) into ``log_dir``; ``time_fn``
is a wall-clock timer that synchronises the card before reading the clock.

Spans. ``span(name, **args)`` is a ``torch.profiler.record_function`` region
named ``r3dgs.<name>``, with ``args`` as its argument string; ``annotate``
is the same region under the name it is given. A span records only while a
profiler records (``trace``, or any ``torch.profiler.profile`` around the
code); otherwise it is one shared no-op context, and costs one attribute
read. Spans sit on the profiler's clock beside the kernels, so a kernel,
through the runtime call that launched it, and an idle gap of the card,
through the moment it opens, can be put down to the span the host was in.
The program's spans:

  r3dgs.window (step, k)   ``AbstractTrainer.step_many``: a window of k steps
                           from ``step``, the hooks after it included
  r3dgs.step (step)        ``AbstractTrainer.step``: one step and its hooks
  r3dgs.forward            the engine's render through the key buffer and the
                           loss (``BaseTrainer.forward_loss``)
  r3dgs.backward           ``loss.backward()`` of a step; autograd launches the
                           kernels from its own thread meanwhile
  r3dgs.optimizer          the cameras' Adam, the model's Adam and the
                           densification statistics
  r3dgs.hooks              the ``optim_step`` chain after a step or window
  r3dgs.render             ``ops.rasterize.tiled.render_tiled``, holding
  r3dgs.preprocess         the projection (SH colours, rectangles, depths);
                           also, just before ``r3dgs.render``, the model's
                           arrays (``GaussianModel.render``: scales,
                           rotations, the SH coefficients masked by degree)
  r3dgs.bin_and_sort       entries emitted and sorted, tile ranges
  r3dgs.composite          field packing, the gather, the compositor and
                           the stitched images
  r3dgs.frame              ``ViewerApp.render_image``: a viewer frame,
                           camera, render and copy to the host
  r3dgs.encode             ``ViewerApp.render_frame``'s PNG encode
  r3dgs.sync.<site>        a deliberate read of the card by the host (below)
  r3dgs.capture            ``ops.rasterize.launches.capture_graph``: a CUDA graph
                           captured (the step's or a sweep pass's)
  r3dgs.sweep_pass         ``ops.rasterize.sweep.static_sweep``: one pass over
                           the views through the static key buffer
  r3dgs.event.<kind>       an event: ``densify`` (the densifier chain's
                           instruction, computed and applied: split and
                           clone, opacity, importance and mercy pruning
                           together), ``sh_cull``, ``quantize`` (the codebook
                           update at the start of a step)
  r3dgs.event.split_clone  inside ``event.densify``: the split and clone
                           selection and its new rows (``SplitCloneDensifier``)
  r3dgs.event.prune        inside it: the opacity and size mask
                           (``OpacityPruner.prune``)
  r3dgs.event.mercy        inside it: ``pruning.trainer.mercy_gaussians``,
                           holding
  r3dgs.knn                ``ops.knn.knn`` (wherever it is called) and
  r3dgs.redundancy         the pixel size over the cameras, the intersection,
                           the minimum allocation and the mercy policy
  r3dgs.event.importance   inside ``event.densify``: the importance prune's
                           sweep over every view, its scores and its mask
                           (``ImportancePruner.densify_and_prune``), holding
                           ``r3dgs.sweep_pass``
  r3dgs.event.apply        inside ``event.densify``: the instruction applied,
                           its rows gathered and the state installed
                           (``DensificationTrainer.apply_instruction``)

Counters. ``count(name, n)`` adds to a dict of Python numbers; it runs only
at the rare sites below, never per kernel, and always. ``tally(name, n)``
holds a count that is still on the card (a 0-d tensor) until
``flush_tallies``, which reads every held count in one transfer (the sync
site ``event_counts``) and adds them: an event's masks are counted so, when
the event is applied.
``counters()`` returns a copy of it with the kernels' launch tallies
(``<module>.<wrapper>.launches`` of each wrapper ``ops/rasterize/launches``
counts: ``composite.composite_fwd`` and the other compositors,
``preprocess_kernel.preprocess_fwd`` and ``.preprocess_bwd``, the binning's,
``optimizer.adam_fused``: one an Adam step of each optimizer state), and
``reset_counters()`` clears it. ``train.training`` prints them in one line
at the end of a run. The program's counters:

  host_syncs, host_syncs.<site>  deliberate reads of the card by the host, all
                           and by site: ``entry_count`` (``bin_and_sort``
                           without a key buffer), ``overflow_drain``
                           (``BaseTrainer._note_overflow``), ``frame_copy``
                           (``viewer.to_uint8``), ``sweep_overflow`` (a
                           sweep pass's overflow flag), ``log`` and ``psnr``
                           (``train.training``), ``event_rows`` (an event's
                           row selections, one per tensor cut by a mask),
                           ``event_counts`` (an event's tallies)
  key_buffer.drains        reads of the step's overflow flags (every 64 steps)
  key_buffer.overflows     steps or windows those reads found overflowing
  key_buffer.regrows       the step's buffer doubled (at a drain, or by a
                           sweep that overflowed it)
  key_buffer.shrinks       the step's buffer cut toward its largest count
  graph.captures, graph.capture_ms   CUDA graphs captured, and their wall ms
  sweep.passes, sweep.regrows        static sweep passes, and the passes that
                           overflowed and doubled the sweep's buffer
  sweep.views              the views those passes rendered, each pass's first
                           (eager) view included
  events.<kind>, events.<kind>.added, events.<kind>.removed   events applied,
                           and the Gaussians they added and removed
  events.clone.added, events.split.added   the rows a densify event's clones
                           and split children add (their sum is
                           ``events.densify.added``)
  events.prune.removed, events.mercy.removed, events.importance.removed
                           the rows the opacity and size mask, the mercy mask
                           and the importance mask remove, each over the rows
                           before the event (a row may be in more than one,
                           and in the split's sources)
  events.importance        importance prunes computed; their removed rows
                           are tallied only while a profiler records
  knn.points               the points ``ops.knn.knn`` searched
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# The context a span gives while no profiler records.
NO_SPAN = contextlib.nullcontext()
_counters: Dict[str, float] = {}
# Counts still on the card: (name, 0-d tensor), read by flush_tallies.
_tallies: List[Tuple[str, torch.Tensor]] = []


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


def recording() -> bool:
    """Whether a profiler records now."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str):
    """A named region in the profiler's trace, while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)


def span(name: str, **args):
    """The region ``r3dgs.<name>`` in the profiler's trace, its argument
    string ``k=v`` pairs of ``args``, while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(
        f"r3dgs.{name}", ", ".join(f"{k}={v}" for k, v in args.items()) or None)


def sync(site: str, n: int = 1):
    """A deliberate read of the card by the host at ``site`` (``n`` of them):
    counted under ``host_syncs`` and ``host_syncs.<site>``, and spanned as
    ``r3dgs.sync.<site>``; nothing when ``n`` is 0."""
    if not n:
        return NO_SPAN
    count("host_syncs", n)
    count(f"host_syncs.{site}", n)
    return span(f"sync.{site}")


def count(name: str, n=1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def tally(name: str, n: torch.Tensor):
    """Add the count ``n``, a 0-d tensor that may still be on the card, to
    the counter ``name`` at the next ``flush_tallies``."""
    _tallies.append((name, n))


def flush_tallies():
    """Read the held tallies in one transfer and add them to their
    counters; nothing when none is held."""
    if not _tallies:
        return
    with sync("event_counts"):
        values = torch.stack([n.to(torch.float64) for _, n in _tallies]).tolist()
    for (name, _), value in zip(_tallies, values):
        count(name, int(value))
    _tallies.clear()


def counters() -> Dict[str, float]:
    """A copy of the counters, with the kernels' launch tallies."""
    # The kernels' modules register their wrappers when they are imported.
    from ..ops.rasterize import binning_kernel, composite, launches, preprocess_kernel  # noqa: F401
    from ..trainer import optimizer  # noqa: F401
    out = dict(_counters)
    for wrapper in launches.wrappers():
        module = wrapper.__module__.rsplit(".", 1)[-1]
        out[f"{module}.{wrapper.__name__}.launches"] = wrapper.launches
    return out


def reset_counters():
    """Clear the counters and the held tallies (the compositor's launch
    tallies stay)."""
    _counters.clear()
    _tallies.clear()
