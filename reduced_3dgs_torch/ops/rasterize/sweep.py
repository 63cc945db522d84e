"""Event sweeps through the static key buffer (the counterpart, on the card,
of the JAX package's one-program sweeps, reduced_3dgs_tpu/importance/
trainer.py:88-140 and ops/shculling_stats.py:105-155), and the capture
recipe they share with the training step's graph (``capture_graph``).

``static_sweep`` runs a sweep: every view renders through a static key
buffer of K entries, a per-view body adds into accumulators on the device
and ORs the buffer's overflow flag, and one host read at the end of the
pass decides whether K doubles, up to N x tiles, and the pass runs again,
as JAX's ``_sweep_counts`` does. The caller gives the starting K (else
``start_key_buffer``) and ``on_regrow(K)``, which hands a regrown K to
whoever sizes the step's buffer. On the card each pass is one
``SweepGraph``: the body runs eagerly for the first view on a side stream
(its contribution counts), is captured, and is replayed for every other
view with the view's matrices copied into the graph's fixed inputs. The
graph and its memory pool are dropped when the pass ends: every training
sweep renders parameters that the event before it replaced, so a kept graph
would never replay again. On the CPU the same fixed-shape body runs once
per view. The body makes no host sync and keeps no record per view.

Which sweeps run so (``sweeps_statically``): more than one view, all of
one image size (``dataset.camera.stackable``) and one FoV, of a model whose
renderer pays only for the entries a tile holds (``static_sweeps``). Other
views take the caller's loop, one eager render per view at its exact entry
count. The FoV must be one because ``camera_settings`` turns it into Python
floats (the tangents), which a graph freezes, and a capture costs an eager
view and 17.9-385.8 ms against 2.05-2.32 ms a replayed view (NVIDIA H100
80GB HBM3, 700 W; PERF.md §6): views with their own intrinsics
would each pay a capture and never replay. Feeding the tangents as device
tensors instead would round the focal lengths and the clamp limits in
float32 where the eager render rounds them from float64, so the graph
could bin an entry the eager render does not; the step's graph is keyed by
FoV for the same reason. The reference's datasets give one FoV to all
views: its COLMAP conversion (convert.py) calibrates one shared camera
(``--ImageReader.single_camera 1``), and a synthetic Blender scene has one
``camera_angle_x``.

A capture that fails raises: there is no eager fallback.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ...dataset import camera as camera_mod
from ...utils import profiling
from . import composite
from .tiled import bucket_capacity, default_key_buffer_size, max_key_buffer

# The camera fields a sweep's body reads that hold tensors.
INPUT_FIELDS = ("world_view_transform", "full_proj_transform", "camera_center", "bg_color")


def capture_graph(eager, captured, device):
    """PyTorch's recipe for capturing work: ``eager()`` runs once on a side
    stream, then ``captured()`` is captured into a new ``CUDAGraph``
    (``torch.cuda.graph`` empties the allocator's cache first), with the
    compositor launches the capture records. Returns (graph, eager()'s
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
        before = dict(composite.captured_launches)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = captured()
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - t0
    profiling.count("graph.captures")
    profiling.count("graph.capture_ms", capture_s * 1e3)
    tally = {name: composite.captured_launches[name] - n for name, n in before.items()}
    pool_bytes = pool_size(graph) if profiling.recording() else None
    return graph, first, out, tally, capture_s, pool_bytes


def pool_size(graph) -> int:
    """The bytes of the card's memory that ``graph``'s private pool holds,
    from a walk of the allocator's snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(graph.pool()))


def _fov(camera) -> tuple:
    return camera.image_height, camera.image_width, camera.FoVx, camera.FoVy


def sweeps_statically(model, cameras) -> bool:
    """Whether a sweep of ``model`` over ``cameras`` runs through the
    static key buffer (see the module docstring)."""
    cams = list(cameras)
    return (model.static_sweeps and len(cams) > 1 and camera_mod.stackable(cams)
            and len({_fov(c) for c in cams}) == 1)


def start_key_buffer(n: int, camera) -> int:
    """The key buffer a sweep of n Gaussians at ``camera``'s image size
    starts from when its caller holds none: ``default_key_buffer_size`` of
    the capacity tier of n (JAX importance/trainer.py:129-137)."""
    return default_key_buffer_size(bucket_capacity(n), -(-camera.image_width // 16),
                                   -(-camera.image_height // 16))


class SweepGraph:
    """A sweep pass's per-view body captured on its first view ``camera``.
    ``body(model, camera)`` renders through the static key buffer, adds
    into its accumulators in place and returns the render's 0-d overflow
    flag; it runs eagerly for ``camera`` (its contribution counts) and is
    then captured. ``replay(camera)`` adds another view of the same image
    size and FoV. ``overflow`` is the OR of the views' flags so far;
    ``capture_s`` the capture's wall seconds (the eager view excluded) and
    ``pool_bytes`` the size of the graph's memory pool (None unless a
    profiler recorded the capture)."""

    def __init__(self, model, body, camera):
        self.overflow = torch.zeros((), dtype=torch.bool, device=model._xyz.device)
        self.camera = dataclasses.replace(camera, **{f: getattr(camera, f).detach().clone()
                                                     for f in INPUT_FIELDS})

        def view():
            self.overflow |= body(model, self.camera)

        self.graph, _, _, self.tally, self.capture_s, self.pool_bytes = capture_graph(
            view, view, self.overflow.device)

    def replay(self, camera):
        if _fov(camera) != _fov(self.camera):
            raise ValueError(f"a sweep graph captured at {_fov(self.camera)} (height, width, "
                             f"FoVx, FoVy) cannot replay a view at {_fov(camera)}")
        for f in INPUT_FIELDS:
            getattr(self.camera, f).copy_(getattr(camera, f))
        self.graph.replay()
        composite.add_replayed_launches(self.tally)


def _graph_pass(model, cameras, body) -> bool:
    """One pass on the card; the graph and its pool go when it returns."""
    graph = SweepGraph(model, body, cameras[0])
    for camera in cameras[1:]:
        graph.replay(camera)
    with profiling.sync("sweep_overflow"):
        return bool(graph.overflow)


@torch.no_grad()
def static_sweep(model, cameras, make_body, make_accumulators, key_buffer=None,
                 on_regrow=None) -> dict:
    """Sweep ``model`` over ``cameras`` (``sweeps_statically``) through the
    static key buffer: ``make_body(K, accumulators)`` is the per-view body
    (see ``SweepGraph``) over the dict of zeroed tensors
    ``make_accumulators()``. K starts at ``key_buffer``, else
    ``start_key_buffer``. After a pass that overflowed, K becomes min(2K,
    N x tiles), ``on_regrow(K)`` is called when given (JAX
    importance/trainer.py:129-140) and the pass runs again from zeroed
    accumulators. Returns the last pass's accumulators."""
    cam0 = cameras[0]
    n = model.num_points
    K = key_buffer or start_key_buffer(n, cam0)
    while True:
        profiling.count("sweep.passes")
        with profiling.span("sweep_pass", views=len(cameras), K=K):
            acc = make_accumulators()
            body = make_body(K, acc)
            if model._xyz.device.type == "cuda":
                overflow = _graph_pass(model, cameras, body)
            else:
                flag = torch.zeros((), dtype=torch.bool)
                for camera in cameras:
                    flag |= body(model, camera)
                with profiling.sync("sweep_overflow"):
                    overflow = bool(flag)
        if not overflow:
            return acc
        profiling.count("sweep.regrows")
        K = min(2 * K, max_key_buffer(n, -(-cam0.image_width // 16),
                                      -(-cam0.image_height // 16)))
        if on_regrow is not None:
            profiling.count("key_buffer.regrows")
            on_regrow(K)
