"""Event sweeps through the static key buffer (the counterpart, on the card,
of the JAX package's one-program sweeps, reduced_3dgs_tpu/importance/
trainer.py:88-140 and ops/shculling_stats.py:105-155).

``static_sweep`` runs a sweep: every view renders through a static key
buffer of K entries, a per-view body adds into accumulators on the device
and ORs the buffer's overflow flag, and one host read at the end of the
pass decides whether K doubles, up to N x tiles, and the pass runs again,
as JAX's ``_sweep_counts`` does. The caller gives the starting K (else
``start_key_buffer``) and ``on_regrow(K)``, which hands a regrown K to
whoever sizes the step's buffer. On the card each pass is one
``SweepGraph`` (a ``launches.CameraGraph``): the body runs eagerly for the
first view on a side stream (its contribution counts), is captured, and is
replayed for every other view with the view's matrices copied into the
graph's fixed inputs. The graph and its memory pool are dropped when the
pass ends: every training sweep renders parameters that the event before it
replaced, so a kept graph would never replay again. On the CPU the same
fixed-shape body runs once per view. The body makes no host sync and keeps
no record per view.

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

import torch

from ...dataset import camera as camera_mod
from ...utils import profiling
from .launches import CameraGraph
from .tiled import bucket_capacity, default_key_buffer_size, max_key_buffer

# The camera fields a sweep's body reads that hold tensors.
INPUT_FIELDS = ("world_view_transform", "full_proj_transform", "camera_center", "bg_color")


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


class SweepGraph(CameraGraph):
    """A sweep pass's per-view body captured on its first view ``camera``.
    ``body(model, camera)`` renders through the static key buffer, adds
    into its accumulators in place and returns the render's 0-d overflow
    flag; it runs eagerly for ``camera`` (its contribution counts) and is
    then captured. ``replay(camera)`` adds another view of the same image
    size and FoV. ``overflow`` is the OR of the views' flags so far."""

    def __init__(self, model, body, camera):
        self.overflow = torch.zeros((), dtype=torch.bool, device=model._xyz.device)

        def view(cam):
            self.overflow |= body(model, cam)

        super().__init__(camera, INPUT_FIELDS, view, view, self.overflow.device)

    def replay(self, camera):
        if _fov(camera) != _fov(self.camera):
            raise ValueError(f"a sweep graph captured at {_fov(self.camera)} (height, width, "
                             f"FoVx, FoVy) cannot replay a view at {_fov(camera)}")
        super().replay(camera)


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
        profiling.count("sweep.views", len(cameras))
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
