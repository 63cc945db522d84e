"""The training loop (counterpart of reduced_3dgs_tpu/train.py:26-178).

``training`` runs one trainer step per camera, in an order shuffled each
epoch, and saves the model's PLY and the dataset's cameras.json at the
``save_iterations`` and at the end. It reads the loss on the host only every
``log_interval`` steps, where it prints the progress and aborts on a
non-finite loss.

Until the mode registry is ported, the entry point is a trainer driven by
``training``. The flagship is the ``densify-pruning-shculling`` mode's
trainer, started as a user starts it, from the COLMAP sparse points: it
densifies (split, clone, opacity prune, opacity reset, depth supervision),
prunes by redundancy ("mercy") and by rendered importance, and culls SH
bands::

    dataset = prepare_dataset(source, device="cuda")
    model = colmap_init(VariableSHGaussianModel(3, device="cuda"), source)
    trainer = SHCullingOpacityResetFullReducedDensificationTrainer(model, dataset)
    training(dataset, model, trainer, None, out_dir,
             iteration=30000, save_iterations=[7000, 30000])

(``dataset.colmap_init``, ``combinations``; ``model.load_ply(path)``
starts from a PLY instead, and a plain ``trainer.Trainer(model, dataset)``
trains without events.) ``main`` and its ``--mode`` registry are not ported
yet.
"""
from __future__ import annotations

import math
import os
import random
import shutil
from typing import List, Optional

import torch

from .trainer import AbstractTrainer
from .utils.device import resolve_device
from .utils.math import psnr


def save_cfg_args(destination: str, sh_degree: int, source: str):
    """The cfg_args file that vanilla-3DGS viewers read."""
    os.makedirs(destination, exist_ok=True)
    with open(os.path.join(destination, "cfg_args"), "w") as f:
        f.write("Namespace(data_device='cuda', eval=False, images='images', "
                f"model_path={destination!r}, resolution=-1, "
                f"sh_degree={sh_degree}, source_path={source!r}, "
                "white_background=False)")


def training(dataset, gaussians, trainer: AbstractTrainer, quantizer, destination: str,
             iteration: int, save_iterations: List[int], device="cuda",
             log_interval: int = 10,
             generator: Optional[random.Random] = None) -> List[torch.Tensor]:
    """Train for ``iteration`` steps; returns the per-step losses as 0-d
    tensors on the device (read them on the host once, after the loop).

    ``device`` is where the run must take place; it defaults to CUDA and
    raises without it, and a model that lies elsewhere raises too. Epochs are
    shuffled with ``generator`` (``random.Random(0)`` when None).
    ``quantizer``, when given, also writes the quantized PLY at each save."""
    device = resolve_device(device)
    model_device = gaussians._xyz.device
    if model_device.type != device.type:
        raise ValueError(f"training on {device} but the model lies on {model_device}")
    rng = generator if generator is not None else random.Random(0)
    shutil.rmtree(os.path.join(destination, "point_cloud"), ignore_errors=True)
    order = list(range(len(dataset)))
    epoch_psnr: List[torch.Tensor] = []
    avg_psnr = 0.0
    ema_loss = 0.0
    losses: List[torch.Tensor] = []

    def save(step):
        save_path = os.path.join(destination, "point_cloud", f"iteration_{step}")
        os.makedirs(save_path, exist_ok=True)
        gaussians.save_ply(os.path.join(save_path, "point_cloud.ply"))
        dataset.save_cameras(os.path.join(destination, "cameras.json"))
        if quantizer:
            quantizer.save_quantized(gaussians,
                                     os.path.join(save_path, "point_cloud_quantized.ply"))

    for step in range(1, iteration + 1):
        pos = (step - 1) % len(dataset)
        if pos == 0:
            if epoch_psnr:
                avg_psnr = float(torch.stack(epoch_psnr).mean())
            epoch_psnr = []
            rng.shuffle(order)
        camera = dataset[order[pos]]
        loss, out = trainer.step(camera)
        losses.append(loss)
        if camera.ground_truth_image is not None:
            epoch_psnr.append(psnr(out["render"].detach(), camera.ground_truth_image).mean())
        ema_loss = 0.4 * loss + 0.6 * ema_loss
        if step % log_interval == 0:
            loss_now = float(ema_loss)
            if not math.isfinite(loss_now):
                raise RuntimeError(f"non-finite loss {loss_now} at step {step}")
            print(f"Training {step}/{iteration}: epoch {step // len(dataset)} "
                  f"loss {loss_now:.6f} psnr {avg_psnr:.4f} n {gaussians.num_points}",
                  flush=True)
        if step in save_iterations:
            save(step)
    save(iteration)
    return losses
