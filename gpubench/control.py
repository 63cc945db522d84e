"""The readings that set each cell's limits: the control (the reference put
in the program's place and computed in bfloat16, the precision below the
configuration's float32) and the faults a cell can have, planted in the
reference put in the program's place, each compared with the float32
reference as a run compares the program.

Training cells: ``bf16``; ``half`` (the loss over half of the image's rows,
the mean taken over the rest); ``altered`` (one 16 x 16 block of the
rendered image raised by 0.05 where it is produced). A state left unchanged
reads 1 by the change gap and needs no run. Rendering cells: ``bf16`` and
``altered`` (one block of one frame raised by 20 levels).

    python -m gpubench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed and variant. It runs on the card (``--device
cpu`` with the tests' tiny overrides is for the tests).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from gpubench import correctness, program, run, scene
from gpubench.drivers import render as render_driver
from gpubench.reference import render as ref_render
from gpubench.reference import train as ref_train

TRAIN_VARIANTS = ("bf16", "half", "altered")
RENDER_VARIANTS = ("bf16", "altered")


@contextlib.contextmanager
def planted(fault: str):
    """The reference's loss with ``fault`` planted (``half``, ``altered``)."""
    original = ref_train.photometric

    def half(image, gt, lam):
        rows = image.shape[1] // 2
        return original(image[:, :rows], gt[:, :rows], lam)

    def altered(image, gt, lam):
        bump = torch.zeros_like(image)
        bump[:, :16, :16] = 0.05
        return original(image + bump, gt, lam)

    ref_train.photometric = {"half": half, "altered": altered}.get(fault, original)
    try:
        yield
    finally:
        ref_train.photometric = original


def training_inputs(cfg: dict, seed: int, device, count: int) -> dict:
    """What a training run of ``seed`` hands both sides: the start model,
    its degrees, the first ``count`` views of the seed's order (the steps
    the reference follows), their images, and the scene extent."""
    camera_mode = cfg["mode"].startswith("camera-")
    poses, fov = scene.orbit_views(cfg["views"], cfg["image_height"], cfg["image_width"])
    true_views = [program.view_args(p, cfg, fov) for p in poses]
    if camera_mode:
        rng = np.random.default_rng(seed % (1 << 63))
        poses = [scene.moved_pose(p, cfg["pose_noise"]["rotation"],
                                  cfg["pose_noise"]["translation"], rng) for p in poses]
    order = next(scene.epoch_orders(len(poses), seed))[:count]
    gt = scene.gt_scene(cfg["scene"], cfg["n_gaussians"], seed, device)
    init = scene.perturbed(gt, cfg["perturb"], seed)
    del gt
    centers = np.stack([-rot.T @ t for rot, t in poses])
    return {"init": init,
            "degrees": scene.sh_degrees(cfg["n_gaussians"], cfg["start_sh_shares"], seed,
                                        device),
            "views": [program.view_args(poses[i], cfg, fov) for i in order],
            "gts": program.reference_ground_truth(cfg, seed, device,
                                                  [true_views[i] for i in order]),
            "extent": ref_train.scene_extent(centers), "camera": camera_mode}


def training_readings(cfg: dict, wl: dict, seed: int, device, variants=TRAIN_VARIANTS):
    """{variant: numbers} for one seed."""
    x = training_inputs(cfg, seed, device, wl["compare_steps"])
    args = (x["init"], x["degrees"], x["views"], x["gts"], cfg, x["extent"], wl["start_step"])
    with correctness.full_float32():
        ref = _side(ref_train.train(*args, camera=x["camera"]), x["init"])
        out = {}
        for variant in variants:
            dtype = torch.bfloat16 if variant == "bf16" else torch.float32
            with planted(variant):
                side = _side(ref_train.train(*args, dtype=dtype, camera=x["camera"]),
                             x["init"])
            out[variant] = correctness.training_numbers(side, ref)
    return out


def _side(result: dict, init: dict) -> dict:
    side = {"losses": result["losses"],
            "grads": {k: g.cpu() for k, g in result["grads"].items()},
            "last_grads": {k: g.cpu() for k, g in result["last_grads"].items()},
            "change": {k: (result["params"][k] - init[k]).cpu() for k in init}}
    side["change"]["densify_accum"] = result["accum"].cpu()
    if "poses" in result:
        side["change"]["camera_pose"] = torch.stack([p.cpu() for p in result["poses"]])
    return side


def render_readings(cfg: dict, wl: dict, seed: int, device, variants=RENDER_VARIANTS):
    """{variant: numbers} for one seed, over ``compare_frames`` poses of the
    seed's stream."""
    n = cfg["n_gaussians"]
    gt = scene.gt_scene(cfg["scene"], n, seed, device)
    params = scene.perturbed(gt, cfg["perturb"], seed)
    del gt
    degrees = scene.sh_degrees(n, cfg["start_sh_shares"], seed, device)
    target = np.asarray(wl["target"], np.float64)
    poses = render_driver.poses(wl, cfg["views"]["radius"], seed, wl["compare_frames"])
    out = {}
    with correctness.full_float32():
        views = [render_driver.reference_view(cfg, *p, target, device) for p in poses]
        ref = [ref_render.to_uint8(ref_render.render(params, degrees, v)["render"])
               for v in views]
        for variant in variants:
            if variant == "bf16":
                frames = [ref_render.to_uint8(ref_render.render(
                    params, degrees, render_driver.reference_view(
                        cfg, *p, target, device), dtype=torch.bfloat16)["render"])
                    for p in poses]
            else:
                frames = [f.copy() for f in ref]
                frames[0][:16, :16] = np.clip(frames[0][:16, :16].astype(np.int16) + 20, 0,
                                              255).astype(np.uint8)
            out[variant] = correctness.frame_numbers(frames, ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, type=int, nargs="+")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    run.cache_environment()
    wl, cfg = run.cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        if wl["driver"] == "render":
            readings = render_readings(cfg, wl, seed, device)
        else:
            readings = training_readings(cfg, wl, seed, device)
        for variant, numbers in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              "numbers": numbers}), flush=True)
        program.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
