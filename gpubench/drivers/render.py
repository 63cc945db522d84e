"""Rendering traffic: one client in a closed loop asks the viewer
(``viewer.ViewerApp.render_image``: the frame as uint8 on the host, no
gradient) for orbit frames at poses drawn from the seed, each request sent
when the last frame has arrived.

Set-up builds the model the training cells start from (the perturbed GT
scene with its SH degrees split) and the viewer, and renders
``warmup_frames`` frames. The measured window then requests frames until
``--seconds`` have passed: ``frame_ms`` is its wall time over its frames
(the 95th percentile of a frame's time goes to standard error only: a
single frame is far shorter than the host's clock reads well). A traced
run traces ``trace_frames`` frames more, and the reference counts the work
of every one of them. ``correct`` compares
``compare_frames`` frames of the window, a uniform sample drawn from the
seed as the window runs (``keep_frame``), with the reference's frames at the
same poses.

Poses: a fixed grid of ``grid`` = (yaw, pitch, radius) cells over the turn,
``pitch`` and the orbit's radius times ``radius_scale``, around ``target``,
in an order shuffled by the seed.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpubench import correctness, program, scene
from gpubench import trace as tracing
from gpubench.reference import render as ref_render


def poses(wl: dict, radius: float, seed: int, count: int) -> np.ndarray:
    """[count, 3] (yaw, pitch, radius): the fixed grid of ``grid`` (yaw,
    pitch, radius) cells, each at its centre, in an order the seed shuffles
    anew each pass, so that every seed asks for the same frames."""
    n_yaw, n_pitch, n_radius = wl["grid"]
    lo, hi = wl["pitch"]
    a, b = wl["radius_scale"]

    def centres(n):
        return (np.arange(n) + 0.5) / n

    grid = np.stack(np.meshgrid(2 * math.pi * centres(n_yaw), lo + (hi - lo) * centres(n_pitch),
                                radius * (a + (b - a) * centres(n_radius)), indexing="ij"),
                    -1).reshape(-1, 3)
    rng = np.random.default_rng(seed % (1 << 63))
    passes = -(-count // len(grid))
    return np.concatenate([rng.permutation(grid) for _ in range(passes)])[:count]


def run(ctx) -> dict:
    from reduced_3dgs_torch.viewer import ViewerApp
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    n = cfg["n_gaussians"]
    gt = scene.gt_scene(cfg["scene"], n, seed, dev)
    params = scene.perturbed(gt, cfg["perturb"], seed)
    del gt
    degrees = scene.sh_degrees(n, cfg["start_sh_shares"], seed, dev)
    model = program.build_model(cfg, params, degrees, dev)
    params = program.host(params)
    app = ViewerApp(model, height=cfg["image_height"], width=cfg["image_width"])
    target = np.asarray(wl["target"], np.float64)
    radius = cfg["views"]["radius"]
    stream = iter(poses(wl, radius, seed, 1 << 16))

    def frame():
        yaw, pitch, r = next(stream)
        return (yaw, pitch, r), app.render_image(yaw, pitch, r, target)

    for _ in range(wl["warmup_frames"]):
        frame()
    program.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start
    program.log(ctx, "set-up done")

    kept, frames = [], 0
    pick = np.random.default_rng(seed % (1 << 63) + 7)
    t0 = time.perf_counter()
    stamps = [t0]
    while stamps[-1] - t0 < ctx.seconds:
        frames += 1
        keep_frame(kept, frame(), frames, wl["compare_frames"], pick)
        stamps.append(time.perf_counter())
    window_s = stamps[-1] - t0
    p95_ms = float(np.percentile(np.diff(stamps), 95)) * 1e3
    program.log(ctx, f"window: {frames} frames in {window_s:.3f} s, p95 of a frame {p95_ms} ms")

    record = None
    if ctx.trace:
        traced = []
        record = tracing.traced(lambda: traced.extend(frame()[0]
                                                      for _ in range(wl["trace_frames"])), dev)
        record.update(units=len(traced), unit_s=window_s / frames, counters={})
        program.log(ctx, "traced window reduced")
    peak = program.memory_peak(dev)
    del app, model
    program.release(dev)

    params = {k: v.to(dev) for k, v in params.items()}
    with correctness.full_float32():
        ref_frames = [ref_render.to_uint8(ref_render.render(
            params, degrees, reference_view(cfg, yaw, pitch, r, target, dev))["render"])
            for (yaw, pitch, r), _ in kept]
        numbers = correctness.frame_numbers([f for _, f in kept], ref_frames)
        if ctx.trace:
            record["work"] = [program.view_work(params, degrees, reference_args(
                cfg, yaw, pitch, r, target), dev) for yaw, pitch, r in traced]
    program.log(ctx, f"reference compared: {numbers}")
    return {"metrics": {"frame_ms": window_s / frames * 1e3, "setup_s": setup_s},
            "numbers": numbers, "attempted": frames, "failed": 0,
            "memory_peak_bytes": peak, "record": record}


def keep_frame(kept: list, done, count: int, size: int, rng):
    """Reservoir sampling: after ``count`` frames, ``kept`` holds a uniform
    sample of ``size`` of them, drawn from the seeded ``rng``, so that the
    window keeps no other frame alive (a viewer drops each frame once it is
    sent)."""
    if len(kept) < size:
        kept.append(done)
    else:
        j = int(rng.integers(count))
        if j < size:
            kept[j] = done


def reference_args(cfg, yaw, pitch, r, target) -> dict:
    rot, t, fovx, fovy = ref_render.orbit_pose(yaw, pitch, r, target, cfg["image_height"],
                                               cfg["image_width"])
    return {"rot": rot, "t": t, "height": cfg["image_height"], "width": cfg["image_width"],
            "fovx": fovx, "fovy": fovy}


def reference_view(cfg, yaw, pitch, r, target, device):
    a = reference_args(cfg, yaw, pitch, r, target)
    return ref_render.make_view(a["rot"], a["t"], a["height"], a["width"], a["fovx"],
                                a["fovy"], device=device)
