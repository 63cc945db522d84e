"""A training step captured as a CUDA graph (the counterpart, on the card,
of the JAX engine's k steps as one XLA program, reduced_3dgs_tpu/trainer/
base.py:223-362).

``StepGraph.capture`` follows PyTorch's recipe for capturing a whole
network: the step runs once eagerly on a side stream (it is the window's
first step), the parameters' gradients are dropped, and the step is
captured into a ``torch.cuda.CUDAGraph`` with its gradients left in the
graph's fixed tensors. The graph reads its camera from fixed tensors: the
camera's view and projection matrices, centre, background, ground truth and
mask and depth maps when it carries them. ``replay`` copies a camera's into
them, replays, counts the compositor launches the capture recorded
(``composite.add_replayed_launches``) and returns a copy of the step's
record (``BaseTrainer.window_step``). Everything else the step touches is
the engine's state, read and written in place at the addresses the key
(``BaseTrainer.graph_key``) holds.

A capture that fails raises: there is no eager fallback. The capture
recipe (``capture_graph``) is the event sweeps' too
(``ops.rasterize.sweep``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterize import composite
from ..ops.rasterize.sweep import capture_graph

# The camera fields a step reads that hold tensors.
INPUT_FIELDS = ("world_view_transform", "full_proj_transform", "camera_center", "bg_color",
                "ground_truth_image", "ground_truth_image_mask", "ground_truth_depth")


class StepGraph:
    """One captured step and its fixed inputs and output. ``capture_s`` is
    the capture's wall time (the warm-up step excluded) and ``pool_bytes``
    the size of the graph's private memory pool, taken only when a profiler
    recorded the capture (else None)."""

    def __init__(self, key, graph, camera, record, first_record, tally, capture_s,
                 pool_bytes):
        self.key = key
        self.graph = graph
        self.camera = camera
        self.record = record
        self.first_record = first_record
        self.tally = tally
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    @classmethod
    def capture(cls, engine, outer, camera, key) -> "StepGraph":
        """Take the window's first step on ``camera`` eagerly, then capture
        the step; ``first_record`` is that first step's record."""
        device = engine.model._xyz.device
        static = dataclasses.replace(camera, **{
            f: getattr(camera, f).detach().clone() for f in INPUT_FIELDS
            if getattr(camera, f) is not None})
        params = engine.model.param_dict().values()
        for p in params:
            p.grad = None
        graph, first_record, record, tally, capture_s, pool_bytes = capture_graph(
            lambda: engine.window_step(outer, static),
            lambda: engine.window_step(outer, static, keep_grads=True), device)
        return cls(key, graph, static, record, first_record, tally, capture_s, pool_bytes)

    def replay(self, camera) -> torch.Tensor:
        """One step on ``camera``: its record [3 or 4] float64, a copy."""
        for f in INPUT_FIELDS:
            dst = getattr(self.camera, f)
            if dst is not None:
                dst.copy_(getattr(camera, f))
        self.graph.replay()
        composite.add_replayed_launches(self.tally)
        return self.record.clone()

