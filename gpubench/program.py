"""What the drivers share: the program's model and cameras built from the
benchmark's inputs, the reference's view of the same inputs, the work count
of a view, and freeing the program's state before the reference runs."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import scene
from .reference import render as ref_render


def log(ctx, msg: str):
    """A progress line on standard error, with the seconds since the start."""
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(config: dict, params: dict, degrees, device, trainable_camera=False):
    """The program's model class of the configuration's backend, holding
    ``params`` (copied) and per-Gaussian ``degrees``, at the full active
    degree."""
    from reduced_3dgs_torch.prepare import get_gaussian_model_class
    cls = get_gaussian_model_class(config["backend"], trainable_camera)
    model = cls(config["sh_degree"], device=device)
    model.set_parameters(params)
    model.aux_set({"degrees": degrees.clone()})
    model.active_sh_degree = config["sh_degree"]
    return model


def program_camera(pose, config: dict, fov, device, image=None):
    from reduced_3dgs_torch.dataset.camera import build_camera
    rot, t = pose
    return build_camera(config["image_height"], config["image_width"], fov[0], fov[1],
                        R=rot.T.astype(np.float32), T=t.astype(np.float32),
                        ground_truth_image=image, device=device)


def view_args(pose, config: dict, fov) -> dict:
    """A pose as the reference takes it."""
    return {"rot": pose[0], "t": pose[1], "height": config["image_height"],
            "width": config["image_width"], "fovx": fov[0], "fovy": fov[1]}


def ground_truth(config: dict, seed: int, device, poses, fov) -> list:
    """The training views' images: the GT scene rendered by the program
    (as the convergence tool makes its captures), clamped to [0, 1]."""
    gt = scene.gt_scene(config["scene"], config["n_gaussians"], seed, device)
    full = torch.full((config["n_gaussians"],), config["sh_degree"], dtype=torch.int32,
                      device=device)
    model = build_model(config, gt["params"], full, device)
    images = []
    with torch.no_grad():
        for pose in poses:
            out = model(program_camera(pose, config, fov, device))
            images.append(torch.clamp(out["render"], 0.0, 1.0).contiguous())
    del model, gt
    return images


def reference_ground_truth(config: dict, seed: int, device, views: list) -> list:
    """The same images, rendered again by the reference from the GT scene."""
    gt = scene.gt_scene(config["scene"], config["n_gaussians"], seed, device)
    full = torch.full((config["n_gaussians"],), config["sh_degree"], dtype=torch.int32,
                      device=device)
    out = []
    for va in views:
        v = ref_render.make_view(va["rot"], va["t"], va["height"], va["width"], va["fovx"],
                                 va["fovy"], device=device)
        out.append(torch.clamp(ref_render.render(gt["params"], full, v)["render"], 0.0, 1.0))
    return out


def view_work(params: dict, degrees, va: dict, device) -> dict:
    """The work of rendering ``params`` at a view, by the reference's own
    binning and compositing: entries, pairs scanned and contributing, the
    image's tiles and pixels, and the Gaussians by SH degree."""
    v = ref_render.make_view(va["rot"], va["t"], va["height"], va["width"], va["fovx"],
                             va["fovy"], device=device)
    out = ref_render.render(params, degrees, v, counts=True)
    tiles_x, tiles_y = v.tiles
    return {"entries": out["entries"], "scanned_pairs": out["scanned_pairs"],
            "contributing_pairs": out["contributing_pairs"], "tiles": tiles_x * tiles_y,
            "pixels": va["height"] * va["width"], "gaussians": int(degrees.numel()),
            "degree_counts": torch.bincount(degrees.long(), minlength=4).tolist()}


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device):
    """Drop what the program left cached, once its objects are deleted."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
