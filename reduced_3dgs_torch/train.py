"""Training CLI and loop (counterpart of reduced_3dgs_tpu/train.py:26-256).

Usage: python -m reduced_3dgs_torch.train -s <colmap_dir> -d <out_dir>
           [--mode densify-pruning-shculling] [--quantize] [--with_scale_reg]
           [-i 30000] [-l <ply>] [-o key=value ...] [--device cuda]
           [--mesh DATAxTILE|auto]

``main`` takes the JAX package's flags. It builds the dataset, the model
(from ``-l``'s PLY, else from the COLMAP sparse points) and the mode's
trainer (``prepare.prepare_trainer``), writes ``cfg_args`` and
``cameras.json``, and runs ``training``. ``-o key=value`` sets any keyword
of the trainers, the quantizer's included, parsed as a Python literal
(else kept as a string). Kernels build into the directory that
``utils.cache.enable_compile_cache`` picks (``$R3DGS_COMPILE_CACHE`` or
``reduced_3dgs_torch/_build/``). ``--device`` defaults to ``cuda`` and raises
without a GPU; ``--device cpu`` runs on the CPU.

``--mesh DATAxTILE`` trains over a (data, tile) mesh of processes
(``parallel.ShardedTrainer``): DATA cameras a step, one per data rank, each
rendered as TILE bands of tile rows, one per tile rank; ``auto`` is 1 x the
world size. Start one process per rank with the variables torchrun sets
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), e.g.
``torchrun --nproc-per-node 2 -m reduced_3dgs_torch.train ... --mesh 1x2``;
each rank runs on ``cuda:LOCAL_RANK`` (modulo the GPUs there are), over NCCL
when each has a GPU of its own and over gloo otherwise, or on the CPU over
gloo with ``--device cpu``. Rank 0 alone writes the files; the state is
replicated, so they are what every rank holds.

The ``camera-*`` modes build a ``TrainableCameraDataset`` and the
camera-trainable model, and learn each view's pose (``--load_camera``
starts from a cameras.json).

``training`` runs one trainer step per camera (n_data cameras a step under a
mesh, as JAX train.py:81-84 takes them), in an order shuffled each epoch,
and saves the model's PLY, cameras.json and, with a quantizer, the
quantized PLY at the ``save_iterations`` and at the end. It takes the steps
in windows (JAX train.py:86-175, the production stepping mode): up to
``R3DGS_WINDOW`` steps (default 16; 1 turns windows off) go through one
``trainer.step_many``, which on the card replays one captured CUDA graph
per step, and a window stops before any step after which a hook would fire
or a schedule advance (``max_window``), at the end of the epoch, at a save
iteration and at the end of training, so the events fire after exactly the
steps they fire after one step at a time. A mesh with more than one data
rank takes windows of one step. cameras.json holds
each view's pose as the trainer learned it (``trainer.adjusted_camera``;
the start pose outside the camera modes), so ``--load_camera`` of it renders
what the trainer renders. (The JAX package writes the start poses there in
every mode.) It reads the loss on the host only at the end of a window that
holds a multiple of ``log_interval``, where it prints the progress; on a
non-finite loss it writes the trainer's state to a failure snapshot
(``utils.debug``) and raises, naming the window's first step as the JAX
loop does.
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
from .parallel import ShardedTrainer, distributed_init, make_mesh
from .parallel.sharding import barrier, is_main_rank, rank_device
from .prepare import backends, modes, prepare_gaussians, prepare_trainer
from .trainer import AbstractTrainer
from .utils import profiling
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
    shuffled with ``generator`` (``random.Random(0)`` when None; every rank
    of a mesh must pass the same). ``quantizer``, when given, also writes
    the quantized PLY at each save. Under a sharded engine each step takes
    the next n_data cameras, every rank the same list; rank 0 alone prints
    and writes the files while the others wait. Steps go in windows of up
    to ``R3DGS_WINDOW`` (see the module docstring); the loss is read on the
    host at the end of each window that holds a log step."""
    device = resolve_device(device)
    model_device = gaussians._xyz.device
    if model_device.type != device.type:
        raise ValueError(f"training on {device} but the model lies on {model_device}")
    rng = generator if generator is not None else random.Random(0)
    main_rank = is_main_rank()
    if main_rank:
        shutil.rmtree(os.path.join(destination, "point_cloud"), ignore_errors=True)
    mesh = getattr(trainer.engine, "mesh", None)
    n_data = mesh.shape["data"] if mesh is not None else 1
    cursor = 0
    order = list(range(len(dataset)))
    epoch_psnr: List[torch.Tensor] = []
    avg_psnr = 0.0
    ema_loss = 0.0
    losses: List[torch.Tensor] = []

    def save(step):
        if main_rank:
            save_path = os.path.join(destination, "point_cloud", f"iteration_{step}")
            os.makedirs(save_path, exist_ok=True)
            gaussians.save_ply(os.path.join(save_path, "point_cloud.ply"))
            CameraDataset([trainer.adjusted_camera(c) for c in dataset],
                          dataset.image_names).save_cameras(
                              os.path.join(destination, "cameras.json"))
            if quantizer:
                quantizer.save_quantized(gaussians,
                                         os.path.join(save_path, "point_cloud_quantized.ply"))
        barrier()

    # Windows of one step under a mesh with several data ranks (JAX
    # train.py:96-100).
    window_max = int(os.environ.get("R3DGS_WINDOW", 16)) if n_data == 1 else 1
    step = 1
    while step <= iteration:
        pos = (step - 1) % len(dataset)
        if pos == 0:
            if epoch_psnr:
                with profiling.sync("psnr"):
                    avg_psnr = float(torch.stack(epoch_psnr).mean())
            epoch_psnr = []
            rng.shuffle(order)
        k = trainer.max_window(window_max) if window_max > 1 else 1
        k = min(k, len(dataset) - pos, iteration - step + 1)
        for s in save_iterations:
            if step <= s <= step + k - 1:
                k = s - step + 1
        if mesh is None:
            cameras = [dataset[order[pos + j]] for j in range(k)]
            camera = cameras[-1]
        else:
            cameras = []
            for _ in range(k):
                cameras.append([dataset[order[(cursor + j) % len(order)]]
                                for j in range(n_data)])
                cursor = (cursor + n_data) % len(order)
            camera = cameras[-1][mesh.data_rank]    # the camera of this rank's image
        if k == 1:
            loss, out = trainer.step(cameras[0])
            window_losses = [loss]
            if camera.ground_truth_image is not None:
                epoch_psnr.append(psnr(out["render"].detach(),
                                       camera.ground_truth_image).mean())
        else:
            window_losses, ys = trainer.step_many(cameras)
            epoch_psnr.extend(ys.get("psnr", ()))
        losses.extend(window_losses)
        for loss in window_losses:
            ema_loss = 0.4 * loss + 0.6 * ema_loss
        last = step + k - 1
        if log_interval - (step - 1) % log_interval <= k:
            with profiling.sync("log"):
                loss_now = float(ema_loss)
            if not math.isfinite(loss_now):
                path = trainer_snapshot(trainer.engine, "nonfinite_loss", camera,
                                        extra={"step": step, "loss": loss_now})
                raise RuntimeError(f"non-finite loss {loss_now} at step {step}"
                                   + (f"; state dumped to {path}" if path else ""))
            if main_rank:
                print(f"Training {last}/{iteration}: epoch {last // len(dataset)} "
                      f"loss {loss_now:.6f} psnr {avg_psnr:.4f} n {gaussians.num_points}",
                      flush=True)
        if last in save_iterations:
            save(last)
        step += k
    save(iteration)
    if main_rank:
        print("Counters: " + " ".join(f"{name}={value:g}" for name, value
                                      in sorted(profiling.counters().items())), flush=True)
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
    parser.add_argument("--mesh", default=None, type=str, metavar="DATAxTILE",
                        help="train over a (data, tile) mesh of processes, e.g. 2x1: two "
                             "cameras a step; 1x2: each camera in two bands; auto: 1 x the "
                             "world size (see the module docstring)")
    parser.add_argument("-o", "--option", default=[], action="append", type=str)
    args = parser.parse_args(argv)
    enable_compile_cache()
    configs = parse_options(args.option)
    device, joined = args.device, False
    try:
        if args.mesh:
            device = rank_device(resolve_device(device))
            joined = distributed_init(device)
            if args.mesh == "auto":
                world = torch.distributed.get_world_size() if joined else 1
                mesh = make_mesh(n_data=1, n_tile=world)
            else:
                n_data, n_tile = (int(x) for x in args.mesh.lower().split("x"))
                mesh = make_mesh(n_data=n_data, n_tile=n_tile)
            configs.setdefault("trainer_constructor", ShardedTrainer)
            configs.setdefault("mesh", mesh)
        dataset, gaussians, trainer, quantizer = prepare_training(
            sh_degree=args.sh_degree, source=args.source, device=device, mode=args.mode,
            load_ply=args.load_ply, load_camera=args.load_camera,
            load_mask=not args.no_image_mask, load_depth=not args.no_depth_data,
            backend=args.backend, with_scale_reg=args.with_scale_reg, quantize=args.quantize,
            load_quantized=args.load_quantized, configs=configs)
        if is_main_rank():
            save_cfg_args(args.destination, args.sh_degree, args.source)
            dataset.save_cameras(os.path.join(args.destination, "cameras.json"))
        return training(dataset=dataset, gaussians=gaussians, trainer=trainer,
                        quantizer=quantizer, destination=args.destination,
                        iteration=args.iteration, save_iterations=args.save_iterations,
                        device=device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
