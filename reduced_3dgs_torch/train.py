"""Training CLI and loop (counterpart of reduced_3dgs_tpu/train.py:26-256).

Usage: python -m reduced_3dgs_torch.train -s <colmap_dir> -d <out_dir>
           [--mode densify-pruning-shculling] [--quantize] [--with_scale_reg]
           [-i 30000] [-l <ply>] [-o key=value ...] [--device cuda]

``main`` takes the JAX package's flags. It builds the dataset, the model
(from ``-l``'s PLY, else from the COLMAP sparse points) and the mode's
trainer (``prepare.prepare_trainer``), writes ``cfg_args`` and
``cameras.json``, and runs ``training``. ``-o key=value`` sets any keyword
of the trainers, the quantizer's included, parsed as a Python literal
(else kept as a string). Kernels build into the directory that
``utils.cache.enable_compile_cache`` picks (``$R3DGS_COMPILE_CACHE`` or
``reduced_3dgs_torch/_build/``). ``--device`` defaults to ``cuda`` and raises
without a GPU; ``--device cpu`` runs on the CPU. ``--mesh`` (training over
several devices) raises: ``parallel/`` is not ported yet (ROADMAP.md item
22).

The ``camera-*`` modes build a ``TrainableCameraDataset`` and the
camera-trainable model, and learn each view's pose (``--load_camera``
starts from a cameras.json).

``training`` runs one trainer step per camera, in an order shuffled each
epoch, and saves the model's PLY, cameras.json and, with a quantizer, the
quantized PLY at the ``save_iterations`` and at the end. cameras.json holds
each view's pose as the trainer learned it (``trainer.adjusted_camera``;
the start pose outside the camera modes), so ``--load_camera`` of it renders
what the trainer renders. (The JAX package writes the start poses there in
every mode.) It reads the loss on the host only every ``log_interval``
steps, where it prints the progress; on a non-finite loss it writes the
trainer's state to a failure snapshot (``utils.debug``) and raises.
"""
from __future__ import annotations

import ast
import math
import os
import random
import shutil
from typing import List, Optional

import torch

from .dataset.dataset import CameraDataset, prepare_dataset
from .prepare import backends, modes, prepare_gaussians, prepare_trainer
from .trainer import AbstractTrainer
from .utils.cache import enable_compile_cache
from .utils.debug import trainer_snapshot
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


def parse_options(options: List[str]) -> dict:
    """``key=value`` strings to a dict, each value a Python literal where it
    parses as one and the string otherwise."""
    configs = {}
    for o in options:
        k, v = o.split("=", 1)
        try:
            configs[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            configs[k] = v
    return configs


def prepare_training(sh_degree: int, source: str, device, mode: str, load_ply: str = None,
                     load_camera: str = None, load_mask: bool = True, load_depth: bool = True,
                     backend: str = "cuda", with_scale_reg: bool = False,
                     quantize: bool = False, load_quantized: str = None, configs=None):
    """(dataset, model, trainer, quantizer or None), every tensor on ``device``."""
    device = resolve_device(device)
    trainable_camera = mode.startswith("camera-")
    dataset = prepare_dataset(source=source, device=device, trainable_camera=trainable_camera,
                              load_camera=load_camera, load_mask=load_mask,
                              load_depth=load_depth)
    gaussians = prepare_gaussians(sh_degree=sh_degree, source=source, device=device,
                                  trainable_camera=trainable_camera, load_ply=load_ply,
                                  backend=backend)
    trainer, quantizer = prepare_trainer(gaussians=gaussians, dataset=dataset, mode=mode,
                                         with_scale_reg=with_scale_reg, quantize=quantize,
                                         load_quantized=load_quantized, configs=configs)
    return dataset, gaussians, trainer, quantizer


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
        CameraDataset([trainer.adjusted_camera(c) for c in dataset],
                      dataset.image_names).save_cameras(os.path.join(destination, "cameras.json"))
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
                path = trainer_snapshot(trainer.engine, "nonfinite_loss", camera,
                                        extra={"step": step, "loss": loss_now})
                raise RuntimeError(f"non-finite loss {loss_now} at step {step}"
                                   + (f"; state dumped to {path}" if path else ""))
            print(f"Training {step}/{iteration}: epoch {step // len(dataset)} "
                  f"loss {loss_now:.6f} psnr {avg_psnr:.4f} n {gaussians.num_points}",
                  flush=True)
        if step in save_iterations:
            save(step)
    save(iteration)
    return losses


def main(argv=None):
    from argparse import ArgumentParser
    parser = ArgumentParser()
    parser.add_argument("--sh_degree", default=3, type=int)
    parser.add_argument("--backend", choices=backends, default="cuda")
    parser.add_argument("-s", "--source", required=True, type=str)
    parser.add_argument("-d", "--destination", required=True, type=str)
    parser.add_argument("-i", "--iteration", default=30000, type=int)
    parser.add_argument("-l", "--load_ply", default=None, type=str)
    parser.add_argument("--load_camera", default=None, type=str)
    parser.add_argument("--quantize", action="store_true")
    parser.add_argument("--no_image_mask", action="store_true")
    parser.add_argument("--no_depth_data", action="store_true")
    parser.add_argument("--with_scale_reg", action="store_true")
    parser.add_argument("--load_quantized", default=None, type=str)
    parser.add_argument("--mode", choices=list(modes), default="densify-pruning-shculling")
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--mesh", default=None, type=str)
    parser.add_argument("-o", "--option", default=[], action="append", type=str)
    args = parser.parse_args(argv)
    enable_compile_cache()
    if args.mesh:
        raise NotImplementedError("--mesh: training over several devices (parallel/) is not "
                                  "ported yet (ROADMAP.md item 22)")
    configs = parse_options(args.option)
    dataset, gaussians, trainer, quantizer = prepare_training(
        sh_degree=args.sh_degree, source=args.source, device=args.device, mode=args.mode,
        load_ply=args.load_ply, load_camera=args.load_camera,
        load_mask=not args.no_image_mask, load_depth=not args.no_depth_data,
        backend=args.backend, with_scale_reg=args.with_scale_reg, quantize=args.quantize,
        load_quantized=args.load_quantized, configs=configs)
    save_cfg_args(args.destination, args.sh_degree, args.source)
    dataset.save_cameras(os.path.join(args.destination, "cameras.json"))
    return training(dataset=dataset, gaussians=gaussians, trainer=trainer, quantizer=quantizer,
                    destination=args.destination, iteration=args.iteration,
                    save_iterations=args.save_iterations, device=args.device)


if __name__ == "__main__":
    main()
