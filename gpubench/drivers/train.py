"""Training traffic: the mode's trainer steps through ``train.training``'s
window loop, frozen here without its saves (``Loop``), over the training
views in an order shuffled each epoch from the seed.

Set-up builds the scene and the views' images on the card, the model the
workload starts from and the mode's trainer (``prepare.prepare_trainer``,
the program's factory), and sets the trainer to ``start_step`` (its step,
Adam's count, the full SH degree) as a resumed checkpoint would. It then
drives that trainer from the seed through the loop's own calls: the first
``compare_steps`` steps, which the reference follows (a window of one step,
then one window of the rest: where the step graph is used, its eager first
step and replays), and ``warmup_steps`` more, which pass the key buffer's
drains. The first step's gradient is read from Adam's first moment, the
last compared step's from the tensors Adam read it from (``hold_grads``: in
a replay, the step graph's fixed gradient tensors). The measured window
then runs whole windows until ``--seconds`` have passed; ``step_ms`` is its
wall time, synchronised at the end, over its steps. A traced run traces
``trace_steps`` steps more, and the reference counts the work of every view
they rendered.

Workload keys: ``start_step``, ``compare_steps``, ``warmup_steps``,
``trace_steps``, ``window`` (``R3DGS_WINDOW`` of the loop), and
``step_metric``, the name the cell reports the step time under
(``step_ms`` when absent).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpubench import correctness, program, scene
from gpubench import trace as tracing
from gpubench.reference import train as ref_train

B1 = 0.9


class Loop:
    """``reduced_3dgs_torch.train.training``'s loop without its saves: each
    window takes ``trainer.max_window(window)`` steps, cut at the epoch's
    end (and at ``limit``); one step goes through ``trainer.step``, more
    through ``trainer.step_many``; the EMA of the loss is read on the host
    at the end of each window that holds a multiple of ``log_interval``,
    and the epoch's mean PSNR at each epoch's start."""

    def __init__(self, trainer, dataset, orders, window: int = 16, log_interval: int = 10):
        from reduced_3dgs_torch.utils.math import psnr
        self.psnr = psnr
        self.trainer, self.dataset, self.orders = trainer, dataset, orders
        self.window_max, self.log_interval = window, log_interval
        self.order = None
        self.step = 1
        self.ema_loss = 0.0
        self.epoch_psnr, self.avg_psnr = [], 0.0
        self.losses, self.views = [], []
        self.nonfinite = 0

    def run(self, steps: int):
        end = self.step + steps
        while self.step < end:
            self.window(end - self.step)

    def window(self, limit=None):
        pos = (self.step - 1) % len(self.dataset)
        if pos == 0:
            if self.epoch_psnr:
                self.avg_psnr = float(torch.stack(self.epoch_psnr).mean())
            self.epoch_psnr = []
            self.order = next(self.orders)
        k = self.trainer.max_window(self.window_max) if self.window_max > 1 else 1
        k = min(k, len(self.dataset) - pos, limit or k)
        cameras = [self.dataset[self.order[pos + j]] for j in range(k)]
        with tracing.span("window"):
            if k == 1:
                loss, out = self.trainer.step(cameras[0])
                window_losses = [loss]
                self.epoch_psnr.append(self.psnr(out["render"].detach(),
                                                 cameras[0].ground_truth_image).mean())
            else:
                window_losses, ys = self.trainer.step_many(cameras)
                self.epoch_psnr.extend(ys.get("psnr", ()))
        self.losses.extend(window_losses)
        self.views.extend(self.order[pos:pos + k])
        for loss in window_losses:
            self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        if self.log_interval - (self.step - 1) % self.log_interval <= k:
            with tracing.span("log_read"):
                if not math.isfinite(float(self.ema_loss)):
                    self.nonfinite += 1
        self.step += k


def hold_grads(params: dict):
    """Hooks that keep, for each parameter, the tensor its gradient was
    accumulated into at the latest backward, the one Adam then reads: in a
    captured step the graph's fixed tensor, which each replay writes anew.
    Returns (held, remove)."""
    held = {}

    def keeper(name):
        def keep(p):
            held[name] = p.grad
        return keep

    handles = [p.register_post_accumulate_grad_hook(keeper(k)) for k, p in params.items()]

    def remove():
        for h in handles:
            h.remove()
    return held, remove


def run(ctx) -> dict:
    from reduced_3dgs_torch.dataset.dataset import CameraDataset, TrainableCameraDataset
    from reduced_3dgs_torch.prepare import prepare_trainer
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    camera_mode = cfg["mode"].startswith("camera-")
    n = cfg["n_gaussians"]
    poses, fov = scene.orbit_views(cfg["views"], cfg["image_height"], cfg["image_width"])
    images = program.ground_truth(cfg, seed, dev, poses, fov)
    if camera_mode:
        rng = np.random.default_rng(seed % (1 << 63))
        poses = [scene.moved_pose(p, cfg["pose_noise"]["rotation"],
                                  cfg["pose_noise"]["translation"], rng) for p in poses]
    program.log(ctx, f"ground truth of {len(images)} views rendered")
    cameras = [program.program_camera(p, cfg, fov, dev, img) for p, img in zip(poses, images)]
    del images
    dataset = (TrainableCameraDataset if camera_mode else CameraDataset)(cameras)
    gt = scene.gt_scene(cfg["scene"], n, seed, dev)
    init = scene.perturbed(gt, cfg["perturb"], seed)
    del gt
    degrees = scene.sh_degrees(n, cfg["start_sh_shares"], seed, dev)
    model = program.build_model(cfg, init, degrees, dev, camera_mode)
    trainer, _ = prepare_trainer(model, dataset, cfg["mode"],
                                 with_scale_reg=cfg["with_scale_reg"], configs=cfg["options"])
    trainer.curr_step = wl["start_step"]
    trainer.engine.adam.count.fill_(wl["start_step"])
    model.active_sh_degree = cfg["sh_degree"]
    init = program.host(init)
    start_poses = [c.world_view_transform.detach().to("cpu", copy=True) for c in cameras]

    loop = Loop(trainer, dataset, scene.epoch_orders(len(dataset), seed), wl["window"])
    engine = trainer.engine
    loop.run(1)
    first_m = program.host(engine.adam.m)
    held, remove = hold_grads(model.param_dict())
    loop.run(wl["compare_steps"] - 1)
    remove()
    last_grads = program.host(held)
    del held
    compared = list(loop.views)
    after = program.host(model.param_dict())
    after["densify_accum"] = engine.xyz_grad_accum.detach().to("cpu", copy=True)
    if camera_mode:
        after["camera_pose"] = torch.stack(
            [trainer.adjusted_camera(cameras[i]).world_view_transform.detach().cpu()
             for i in compared])
    compared_losses = [float(x) for x in loop.losses[:wl["compare_steps"]]]
    program.log(ctx, "compared steps done")
    loop.run(wl["warmup_steps"])
    program.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start
    program.log(ctx, "set-up done")

    n0, losses0 = loop.step, len(loop.losses)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        loop.window()
    program.synchronize(dev)
    window_s = time.perf_counter() - t0
    steps = loop.step - n0
    window_losses = torch.stack(loop.losses[losses0:])
    failed = int((~torch.isfinite(window_losses)).sum()) + loop.nonfinite
    program.log(ctx, f"window: {steps} steps in {window_s:.3f} s")

    record = None
    if ctx.trace:
        t_start = len(loop.views)
        record = tracing.traced(lambda: loop.run(wl["trace_steps"]), dev)
        traced_views = loop.views[t_start:]
        record.update(units=len(traced_views), unit_s=window_s / steps,
                      counters={"key_buffer": engine.key_buffer_for(cameras[0])})
        final = program.host(model.param_dict())
        program.log(ctx, "traced window reduced")
    peak = program.memory_peak(dev)
    del trainer, engine, model, dataset, cameras, loop
    program.release(dev)
    program.log(ctx, "program state released")

    with correctness.full_float32():
        views = [program.view_args(poses[i], cfg, fov) for i in compared]
        true_views = views
        if camera_mode:
            true_poses, _ = scene.orbit_views(cfg["views"], cfg["image_height"],
                                              cfg["image_width"])
            true_views = [program.view_args(true_poses[i], cfg, fov) for i in compared]
        gts = program.reference_ground_truth(cfg, seed, dev, true_views)
        program.log(ctx, "reference ground truth rendered")
        start = {k: v.to(dev) for k, v in init.items()}
        extent = ref_train.scene_extent(np.stack([-rot.T @ t for rot, t in poses]))
        ref = ref_train.train(start, degrees, views, gts, cfg, extent, wl["start_step"],
                              camera=camera_mode)
        numbers = compare(compared_losses, first_m, last_grads, after, init, ref, start_poses,
                          compared)
        numbers["failed_steps"] = failed
        program.log(ctx, f"reference compared: {numbers}")
        if ctx.trace:
            final = {k: v.to(dev) for k, v in final.items()}
            record["work"] = [program.view_work(final, degrees,
                                                program.view_args(poses[i], cfg, fov), dev)
                              for i in traced_views]
            program.log(ctx, "work counted")
    return {"metrics": {wl.get("step_metric", "step_ms"): window_s / steps * 1e3,
                        "setup_s": setup_s},
            "numbers": numbers, "attempted": steps, "failed": failed,
            "memory_peak_bytes": peak, "record": record}


def compare(losses, first_m, last_grads, after, init, ref, start_poses, compared) -> dict:
    """The training numbers of ``correctness`` from the program's state
    (the first gradient from Adam's first moment after one step from zero
    moments, the last as Adam read it) and the reference's."""
    program_side = {
        "losses": losses,
        "grads": {k: m / (1.0 - B1) for k, m in first_m.items()},
        "last_grads": last_grads,
        "change": {k: after[k] - init[k] for k in init},
    }
    program_side["change"]["densify_accum"] = after["densify_accum"]
    reference_side = {
        "losses": ref["losses"],
        "grads": {k: g.cpu() for k, g in ref["grads"].items()},
        "last_grads": {k: g.cpu() for k, g in ref["last_grads"].items()},
        "change": {k: ref["params"][k].cpu() - init[k] for k in init},
    }
    reference_side["change"]["densify_accum"] = ref["accum"].cpu()
    if "camera_pose" in after:
        start = torch.stack([start_poses[i] for i in compared])
        program_side["change"]["camera_pose"] = after["camera_pose"] - start
        reference_side["change"]["camera_pose"] = torch.stack(
            [p.cpu() for p in ref["poses"]]) - start
    return correctness.training_numbers(program_side, reference_side)
