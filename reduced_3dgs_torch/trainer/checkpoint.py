"""Full training-state checkpoint and resume (counterpart of
reduced_3dgs_tpu/trainer/checkpoint.py:21-60).

One ``.npz`` in the JAX package's format: ``params/*``, ``adam_m/*``,
``adam_v/*``, ``aux/*`` and ``accum/*`` (every per-Gaussian tensor of
``BaseTrainer.state_trees``), ``meta/adam_count``, and ``__meta__``, a JSON
object with ``n_alive``, ``curr_step``, ``capacity``, ``active_sh_degree``
and ``spatial_lr_scale``. The port keeps exactly N rows, so it writes
``capacity`` = ``n_alive`` = N. ``load_checkpoint`` keeps the first
``n_alive`` rows of every group, so it also loads the JAX package's
checkpoints, whose groups are padded to their capacity: this carries a JAX
training state across to the port. On one device a resume is bit-exact.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_checkpoint(trainer, path: str):
    """Write the engine state of any (wrapped) trainer to ``path``."""
    engine = trainer.engine
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"{group}/{k}": v.detach().cpu().numpy()
            for group, tree in engine.state_trees().items() for k, v in tree.items()}
    flat["meta/adam_count"] = np.asarray(int(engine.adam.count), np.int32)
    n = engine.model.num_points
    meta = {"n_alive": n, "curr_step": int(engine.curr_step), "capacity": n,
            "active_sh_degree": int(engine.model.active_sh_degree),
            "spatial_lr_scale": float(engine.spatial_lr_scale)}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_checkpoint(trainer, path: str):
    """Restore a state that ``save_checkpoint`` (of either package) wrote.
    The trainer must hold a model of the same maximum SH degree."""
    engine = trainer.engine
    device = engine.model._xyz.device
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        n = meta["n_alive"]
        trees = {group: {k: torch.from_numpy(data[f"{group}/{k}"][:n].copy()).to(device)
                         for k in tree}
                 for group, tree in engine.state_trees().items()}
        adam_count = int(data["meta/adam_count"])
    engine.set_state_trees(trees)
    engine.adam.count.fill_(adam_count)
    engine.curr_step = meta["curr_step"]
    engine.model.active_sh_degree = meta["active_sh_degree"]
    engine.spatial_lr_scale = meta["spatial_lr_scale"]
    return trainer
