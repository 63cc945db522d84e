"""Failure snapshots: the training state, dumped when a run goes wrong
(counterpart of reduced_3dgs_tpu/utils/debug.py:27-100).

``training`` calls ``trainer_snapshot`` on a non-finite loss and then
raises. The snapshot is one flat ``.npz`` of the engine's state (the
parameters, the aux state, the densification statistics, Adam), the step's
camera and a few scalars, under the JAX package's keys, so that either
package's snapshot reads the same way. At most ``MAX_SNAPSHOTS`` are
written per process, so a failing loop cannot fill the disk.

``R3DGS_SNAPSHOT_DIR`` sets the directory (default ./failure_snapshots;
"0" turns snapshots off).

The engine also snapshots a static key buffer that keeps overflowing: the
third drain in a row with an overflow writes ``persistent_overflow_*``
(``BaseTrainer._note_overflow``), with the largest entry count and the
buffer's sizes under ``extra/``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

MAX_SNAPSHOTS = 8
_written = 0


def snapshot_dir() -> Optional[str]:
    d = os.environ.get("R3DGS_SNAPSHOT_DIR", "failure_snapshots")
    return None if d == "0" else d


def _flatten(prefix: str, obj: Any, out: Dict[str, np.ndarray]) -> None:
    """Leaves of dicts, lists and tuples (a tuple's by position, as the JAX
    package flattens its NamedTuples) under "/"-joined keys."""
    if obj is None:
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
        return
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, out)
        return
    if torch.is_tensor(obj):
        out[prefix] = obj.detach().cpu().numpy()
        return
    try:
        out[prefix] = np.asarray(obj)
    except Exception as e:  # a snapshot must never raise from the failure it records
        out[prefix] = np.asarray(f"<unavailable: {type(obj).__name__}: "
                                 f"{e.__class__.__name__}>")


def dump_failure_snapshot(tag: str, state: Dict[str, Any]) -> Optional[str]:
    """Write ``state`` (nested dicts, lists and tuples of tensors, arrays and
    scalars) as one .npz; the path, or None when disabled or over the limit."""
    global _written
    d = snapshot_dir()
    if d is None or _written >= MAX_SNAPSHOTS:
        return None
    os.makedirs(d, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten("", state, flat)
    path = os.path.join(d, f"{tag}_{int(time.time())}_{_written}.npz")
    np.savez_compressed(path, **flat)
    _written += 1
    return path


def trainer_snapshot(trainer, tag: str, camera=None,
                     extra: Optional[dict] = None) -> Optional[str]:
    """Snapshot an engine's state: ``params/*``, ``aux/*``, ``n_alive`` (N:
    every row is alive in the port), ``xyz_grad_accum``, ``xyz_grad_denom``,
    ``max_radii2d``, ``adam/0`` (the step count), ``adam/1/*`` and
    ``adam/2/*`` (the moments), and ``camera/*`` and ``extra/*`` when
    given."""
    state: Dict[str, Any] = {
        "params": trainer.model.param_dict(),
        "aux": trainer.model.aux_state(),
        "n_alive": np.int32(trainer.model.num_points),
    }
    for name in ("xyz_grad_accum", "xyz_grad_denom", "max_radii2d"):
        if hasattr(trainer, name):
            state[name] = getattr(trainer, name)
    adam = getattr(trainer, "adam", None)
    if adam is not None:
        state["adam"] = (adam.count, adam.m, adam.v)
    if camera is not None:
        state["camera"] = {
            "world_view_transform": camera.world_view_transform,
            "full_proj_transform": camera.full_proj_transform,
            "camera_center": camera.camera_center,
            "image_height": camera.image_height,
            "image_width": camera.image_width,
        }
    if extra:
        state["extra"] = extra
    return dump_failure_snapshot(tag, state)
