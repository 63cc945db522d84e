#!/usr/bin/env python3
"""Smoke test of the PyTorch port (reduced_3dgs_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

  phase 0  card name, power limit and software versions
  phase 1  build every CUDA kernel from the sources in the checkout, one
           nvcc process per source, all at once, and print each kernel's
           registers, shared memory and spills as ptxas reports them
  phase 2  the bench scene: 200,000 Gaussians at SH degree 3, 544x976, and
           its perturbed copy (bench.py's perturbation)
  phase 3  the bench scene's entries per tile (mean, p99, max), then each
           kernel against its plain PyTorch version on the card, on
           the bench scene, an opaque scene and a fully culled scene: the
           forward compositor, the statistics compositor (also against the
           forward compositor, bit for bit), the backward compositor
           (cotangents from a real loss and random ones), and the SSIM
           gradient against float64 and against float32 on the CPU
  phase 4  the render entry point (reduced_3dgs_torch.render.main) on a
           4-view COLMAP dataset of the bench scene, with the kernels'
           launch counts read around it
  phase 5  timing with CUDA events (median of 20 after warm-up): each
           kernel and its plain version (and the share of its bound it
           reaches), a render and a training step with
           their stage splits, an importance-pruning sweep and an SH cull
           over the 4 views, and the device idle share under torch.profiler
  phase 6  the training path: train.training() with a Trainer for 20 steps
           on the 4-view dataset from the perturbed bench scene, with the
           kernels' launch counts read around it
  phase 7  the reduction path: train.training() for 30 steps with
           SHCullingTrainerWrapper(BaseImportancePruningTrainer, ...), which
           prunes by importance after steps 10 and 20 and culls SH bands
           after step 15, with the launch counts, N and the degrees read
           around each event

Any failed check raises, so the script exits non-zero without its last
line. The last two lines are a JSON record of each kernel and
{"ok": true, "device": {...}}. Without CUDA it exits with status 2.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_GAUSSIANS = 200_000
HEIGHT, WIDTH = 544, 976
FOVX, FOVY = math.radians(70), math.radians(45)
FOCAL_X, FOCAL_Y = WIDTH / (2 * math.tan(FOVX / 2)), HEIGHT / (2 * math.tan(FOVY / 2))
N_VIEWS = 4
REPEATS = 20
TRAIN_STEPS = 20
# The reduction path of phase 7: importance pruning after steps 10 and 20,
# the SH cull after step 15, one SH band more every 4 steps.
REDUCTION_STEPS = 30
REDUCTION_CONFIG = dict(importance_prune_from_iter=10, importance_prune_until_iter=20,
                        importance_prune_interval=10, cull_at_steps=[15],
                        sh_degree_up_interval=4)
PRUNE_STEPS, CULL_STEPS = (10, 20), (15,)
# Background of the camera whose loss gives the backward compositor's
# cotangents: non-zero, so that the final_T cotangent is too.
LOSS_BG = (0.2, 0.4, 0.6)
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations every (pixel, entry) pair the forward compositor scans
# needs at least: offsets (2), quadratic form (9), exp (1), gate (1).
OPS_PER_SCANNED_PAIR = 13
# The backward compositor evaluates the same 13-operation gate on every
# pair before each pixel's latch, and spends about 27 more on each pair that
# passes it (T_in and w 3, c.g 7, d alpha-bar 4, dpower 2, the conic and
# position partials 11).
OPS_PER_CONTRIBUTING_PAIR = 27
# The statistics compositor spends about 14 more on each pair that
# contributes: the blend (w, four colour sums, T: 10) and the four sums.
OPS_PER_STATS_CONTRIBUTING_PAIR = 14
# Colour and final_T agree to 1e-4 and depth to 5e-4: the bars the JAX
# package holds its own Pallas kernel to against its XLA path. The latch may
# flip where T (1 - alpha) sits on 1e-4, between sequential and log-space
# arithmetic, on at most 0.01% of pixels.
TOL_COLOR, TOL_DEPTH, MAX_LATCH_MISMATCH_SHARE = 1e-4, 5e-4, 1e-4
# Backward compositor vs its plain version, per gradient field: max |diff|
# at most this share of the plain version's max |value| (the kernel replays
# T by division, the plain version in log space, and sums in another order;
# the worst field on the bench and opaque scenes sits near 9e-7).
TOL_BWD_REL = 1e-5
# Statistics compositor vs its plain version: counts exact (the kernel's
# gate rounds as the plain version does) outside tiles whose latch differs;
# each score field within this share of the plain version's max |value|.
TOL_STATS_REL = 1e-5
STAT_FIELDS = ("count", "count_op", "w", "T_in")
# SSIM gradient in float32 on the card vs the same on the CPU, as a share
# of the float64 gradient's max |value| (see check_ssim_gradient).
TOL_SSIM_GRAD_REL = 1e-5
MIN_PSNR_DB = 40.0
FIELDS = ("x", "y", "A", "B", "C", "op", "r", "g", "b", "depth")


def log(msg):
    print(msg, flush=True)


def bench_scene(seed=0):
    """Raw parameters of the bench scene (bench.py's distribution) from numpy."""
    n = N_GAUSSIANS
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                          3.5 + rng.uniform(-1.5, 1.5, (n, 1))], axis=1)
    feats = rng.normal(0.0, 0.2, (n, 16, 3))
    params = dict(
        xyz=xyz,
        features_dc=feats[:, :1] + 0.4,
        features_rest=feats[:, 1:],
        scaling=rng.uniform(-5.5, -4.0, (n, 3)),
        rotation=rng.normal(0.0, 0.1, (n, 4)) + np.array([1.0, 0.0, 0.0, 0.0]),
        opacity=rng.uniform(-2.0, 2.0, (n, 1)))
    return {k: v.astype(np.float32) for k, v in params.items()}


def perturbed(params, seed=7):
    """bench.py's perturbation of the parameters (its gradient gate): the
    trained model starts here, the ground truth is the unperturbed scene."""
    rng = np.random.default_rng(seed)
    sigma = dict(xyz=0.01, features_dc=0.05, features_rest=0.02, scaling=0.1,
                 rotation=0.02, opacity=0.2)
    return {k: (v + sigma[k] * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in params.items()}


def view_poses():
    """COLMAP (qvec, tvec) of the views: small rotations about y and x and
    small translations around the origin."""
    poses = []
    for i in range(N_VIEWS):
        a = 0.03 * (i - (N_VIEWS - 1) / 2)
        b = 0.02 * ((i % 2) - 0.5)
        q = np.array([math.cos(a / 2) * math.cos(b / 2), math.sin(b / 2) * math.cos(a / 2),
                      math.sin(a / 2) * math.cos(b / 2), -math.sin(a / 2) * math.sin(b / 2)])
        q /= np.linalg.norm(q)
        poses.append((q, np.array([0.05 * (i - 1.5), 0.02 * (i % 2), 0.03 * i])))
    return poses


def view_camera(pose, dev, bg_color=(0.0, 0.0, 0.0)):
    """The HEIGHT x WIDTH camera at COLMAP pose (qvec, tvec)."""
    from reduced_3dgs_torch.dataset.camera import build_camera, focal2fov
    from reduced_3dgs_torch.dataset.colmap import qvec2rotmat
    q, t = pose
    return build_camera(HEIGHT, WIDTH, focal2fov(FOCAL_X, WIDTH), focal2fov(FOCAL_Y, HEIGHT),
                        R=qvec2rotmat(q).T, T=t, bg_color=bg_color, device=dev)


def cuda_ms(fn, warmup=3, setup=None):
    """Median milliseconds of fn() over REPEATS runs, each between two CUDA
    events, after `warmup` runs; setup(), when given, runs before each run,
    outside the events."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(REPEATS):
        if setup:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(fn, calls=5):
    """Profile `calls` calls of fn(): (device kernels and copies per call,
    device busy ms per call, wall ms per call, top kernels by device time,
    device ms per call of each kernel name). Busy is the sum of device
    kernel and copy times on the one stream."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in dev)
    top = sorted(dev, key=lambda a: -a.self_device_time_total)[:6]
    by_name = {a.key: a.self_device_time_total / 1e3 / calls for a in dev}
    return (sum(a.count for a in dev) / calls, busy_us / 1e3 / calls, wall_ms / calls,
            [(a.key[:60], a.count // calls, a.self_device_time_total / 1e3 / calls)
             for a in top], by_name)


def print_busy(card, what, stats):
    n_launch, busy_ms, wall_ms, top, _ = stats
    if busy_ms > 0:
        log(f"phase 5 [{card}]: under torch.profiler, per {what}: {n_launch:.0f} device "
            f"kernels and copies, device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
            f"(idle share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log(f"phase 5: device busy share per {what} not measured (the profiler saw no "
            "device time)")


def sorted_entries(model, camera):
    """Preprocess, bin and gather: the compositor's inputs on the main path."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.ops.rasterize.composite import pack_fields
    settings = model.render_settings(camera)
    tiles_x, tiles_y = common.tile_grid(settings)
    pre = common.preprocess(*model.render_array_args(), settings)
    ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                             tiles_x, tiles_y)
    e = pack_fields(pre).index_select(1, ent["s_gidx"]).contiguous()
    return e, ent["range_start"], ent["range_end"], tiles_x, ent["num_rendered"], ent["s_gidx"]


def compare_compositor(name, model, camera):
    """Forward kernel against plain version on one scene; raises past the bars."""
    from reduced_3dgs_torch.ops.rasterize.composite import composite_fwd, composite_fwd_plain
    e, rs, re, tiles_x, k, s_gidx = sorted_entries(model, camera)
    kc, kt, kl = composite_fwd(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    pc, pt, pl = composite_fwd_plain(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    d_color = float((kc[..., :3] - pc[..., :3]).abs().max()) if k else 0.0
    d_depth = float((kc[..., 3] - pc[..., 3]).abs().max()) if k else 0.0
    d_t = float((kt - pt).abs().max())
    mismatch = int((kl != pl).sum())
    n_pix = kl.numel()
    latched = int((kl[..., 0] < re[:, None]).sum())
    empty = int((re == rs).sum())
    log(f"phase 3 [{name}]: num_rendered={k} empty_tiles={empty}/{rs.numel()} "
        f"latched_pixels={latched} max|d color|={d_color:.3e} max|d depth|={d_depth:.3e} "
        f"max|d final_T|={d_t:.3e} latch_mismatch={mismatch}/{n_pix} (bars: colour and "
        f"final_T {TOL_COLOR}, depth {TOL_DEPTH}, latch {MAX_LATCH_MISMATCH_SHARE:.0e} of pixels)")
    if not (d_color <= TOL_COLOR and d_t <= TOL_COLOR and d_depth <= TOL_DEPTH):
        raise AssertionError(f"{name}: composite_fwd disagrees with its plain version")
    if mismatch > MAX_LATCH_MISMATCH_SHARE * n_pix:
        raise AssertionError(f"{name}: {mismatch} latch mismatches of {n_pix} pixels")
    return dict(k=k, max_abs_err=max(d_color, d_depth, d_t), latched=latched, empty=empty,
                tiles=rs.numel(), inputs=(e, rs, re, tiles_x), latch=kl, final_t=kt,
                color4=kc, s_gidx=s_gidx, n=model.num_points)


def compare_stats(name, case):
    """The statistics compositor on the forward compositor's case: its
    colour, T and latch must equal the forward kernel's bit for bit, and its
    statistics its plain version's, per entry and per Gaussian: counts
    exactly outside the tiles whose latch differs between kernel and plain
    version, each score within TOL_STATS_REL of its largest plain value.
    Raises past the bars."""
    from reduced_3dgs_torch.ops.rasterize.composite import (composite_fwd_stats,
                                                            composite_fwd_stats_plain)
    e, rs, re, tiles_x = case["inputs"]
    kc, kt, kl, ks = composite_fwd_stats(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    same = (torch.equal(kc, case["color4"]) and torch.equal(kt, case["final_t"])
            and torch.equal(kl, case["latch"]))
    pc, pt, pl, ps = composite_fwd_stats_plain(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    K, n, s_gidx = e.shape[1], case["n"], case["s_gidx"]
    seg = torch.repeat_interleave(torch.arange(rs.numel(), device=e.device), re - rs,
                                  output_size=K)
    bad_tiles = (kl != pl).flatten(1).any(dim=1)
    ok = ~bad_tiles[seg]                                                  # [K]
    kn = torch.zeros((4, n), device=e.device).index_add_(1, s_gidx, ks)
    pn = torch.zeros((4, n), device=e.device).index_add_(1, s_gidx, ps)
    ok_g = torch.ones(n, dtype=torch.bool, device=e.device)
    ok_g[s_gidx[~ok]] = False
    count_diff = (int((ks[0] != ps[0])[ok].sum()), int((kn[0] != pn[0])[ok_g].sum()))
    worst, max_abs, parts = 0.0, 0.0, []
    for level, kv, pv, sel in (("entry", ks, ps, ok), ("gaussian", kn, pn, ok_g)):
        for f in range(1, 4):
            d = float((kv[f] - pv[f])[sel].abs().max()) if bool(sel.any()) else 0.0
            scale = float(pv[f].abs().max()) if pv.shape[1] else 0.0
            if not math.isfinite(d):
                raise AssertionError(f"{name}: non-finite statistic {STAT_FIELDS[f]}")
            rel = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            worst = max(worst, rel)
            if level == "entry":
                max_abs = max(max_abs, d)
            parts.append(f"{level}/{STAT_FIELDS[f]} {d:.2e}/{scale:.2e}")
    log(f"phase 3 [{name}]: composite_fwd_stats colour, T and latch equal to composite_fwd "
        f"bit for bit: {same}; tiles with a latch mismatch {int(bad_tiles.sum())}; count "
        f"mismatches outside them: {count_diff[0]} entries, {count_diff[1]} Gaussians "
        f"(of {K}, {n}); contributing pairs {int(ps[0].sum())}; max|d|/max|plain| per score: "
        + ", ".join(parts) + f"; worst ratio {worst:.3e} (bar {TOL_STATS_REL})")
    if not same:
        raise AssertionError(f"{name}: composite_fwd_stats composites otherwise than "
                             "composite_fwd")
    if count_diff != (0, 0) or worst > TOL_STATS_REL:
        raise AssertionError(f"{name}: composite_fwd_stats disagrees with its plain version")
    return dict(max_abs_err=max_abs, stats=ks, per_gaussian=kn,
                contributing=int(ps[0].sum()))


def loss_cotangents(model, camera, gt):
    """(g_color4, g_T) of the training loss (0.8 L1 + 0.2 (1 - SSIM)) of
    `model` against `gt` at `camera`, through the port's forward pipeline,
    with the forward kernel's outputs as the leaves."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.ops.ssim import ssim
    from reduced_3dgs_torch.utils.math import l1_loss
    settings = model.render_settings(camera)
    tiles_x, tiles_y = common.tile_grid(settings)
    e, rs, re, _, k, s_gidx = sorted_entries(model, camera)
    from reduced_3dgs_torch.ops.rasterize.composite import composite_fwd
    color4, final_t, latch = composite_fwd(e, rs, re, tiles_x)
    c4 = color4.clone().requires_grad_(True)
    ft = final_t.clone().requires_grad_(True)
    pre = common.preprocess(*model.render_array_args(), settings)
    with torch.enable_grad():
        img = tiled._assemble_outputs(c4, ft, pre, settings, tiles_x, tiles_y, HEIGHT, WIDTH,
                                      k)["render"]
        loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
        g_c4, g_t = torch.autograd.grad(loss, (c4, ft))
    return dict(inputs=(e, rs, re, tiles_x), final_t=final_t, latch=latch, s_gidx=s_gidx,
                n=model.num_points, k=k, g_color4=g_c4.contiguous(), g_t=g_t.contiguous())


def compare_backward(name, case, g_color4, g_t):
    """Backward kernel against plain version on the forward kernel's own
    buffers, per field, per entry [10,K] and per Gaussian [10,N]."""
    from reduced_3dgs_torch.ops.rasterize.composite import composite_bwd, composite_bwd_plain
    e, rs, re, tiles_x = case["inputs"]
    args = (e, rs, re, tiles_x, case["final_t"], case["latch"], g_color4, g_t)
    kg = composite_bwd(*args)
    torch.cuda.synchronize()
    pg = composite_bwd_plain(*args)
    torch.cuda.synchronize()
    n = case["n"]
    kn = torch.zeros((10, n), device=e.device).index_add_(1, case["s_gidx"], kg)
    pn = torch.zeros((10, n), device=e.device).index_add_(1, case["s_gidx"], pg)
    worst, max_abs = 0.0, 0.0
    parts = []
    for level, (kv, pv) in (("entry", (kg, pg)), ("gaussian", (kn, pn))):
        for f, fname in enumerate(FIELDS):
            if kv.shape[1] == 0:
                d = scale = 0.0
            else:
                d = float((kv[f] - pv[f]).abs().max())
                scale = float(pv[f].abs().max())
            if not math.isfinite(d):
                raise AssertionError(f"{name}: non-finite backward gradient in {fname}")
            rel = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            worst = max(worst, rel)
            if level == "entry":
                max_abs = max(max_abs, d)
            parts.append(f"{level}/{fname} {d:.2e}/{scale:.2e}")
    log(f"phase 3 [{name}]: composite_bwd vs plain, max|d|/max|plain| per field: "
        + ", ".join(parts) + f"; worst ratio {worst:.3e} (bar {TOL_BWD_REL})")
    if worst > TOL_BWD_REL:
        raise AssertionError(f"{name}: composite_bwd disagrees with its plain version")
    return dict(max_abs_err=max_abs, grads=kg, plain=pg)


def backward_pairs(e, range_start, range_end, tiles_x, latch):
    """(pairs, contributing) of the backward compositor on these inputs:
    the (pixel, entry) pairs before each pixel's latch, whose gate it must
    evaluate, and those of them that pass the gate (power <= 0 and
    alpha >= 1/255) and so take the gradient arithmetic. Counted on the
    card in chunks of 32 pixels, as composite_bwd_plain selects them."""
    from reduced_3dgs_torch import config
    K, T = e.shape[1], range_start.numel()
    rs, re = range_start.long(), range_end.long()
    lat = latch[..., 0].long()                                          # [T,256]
    pairs = int((lat - rs[:, None]).clamp(min=0).sum())
    seg = torch.repeat_interleave(torch.arange(T, device=e.device), re - rs, output_size=K)
    pos = torch.arange(K, device=e.device)
    tile_x = ((seg % tiles_x) * config.BLOCK_X).float()
    tile_y = ((seg // tiles_x) * config.BLOCK_Y).float()
    x, y, A, B, C, op = e[:6]
    contributing = 0
    for p0 in range(0, config.BLOCK_SIZE, 32):
        p = torch.arange(p0, p0 + 32, device=e.device)[:, None]
        dx = x - (tile_x + (p % config.BLOCK_X).float())
        dy = y - (tile_y + (p // config.BLOCK_X).float())
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=config.ALPHA_MAX)
        live = (power <= 0.0) & (alpha >= config.ALPHA_EPS) & (pos < lat[:, p0:p0 + 32].T[:, seg])
        contributing += int(live.sum())
    return pairs, contributing


def check_ssim_gradient(img, gt):
    """The SSIM gradient on the card in float32 against the same float32
    arithmetic on the CPU, where no convolution runs in TF32. float32 itself
    is some 1e-5 to 1e-4 of the gradient's scale away from float64 (SSIM's
    variances are differences of nearly equal moments), so the bar is on the
    card-vs-CPU gap, which is what TF32 would widen; the float64 gaps of
    both are printed beside it."""
    from reduced_3dgs_torch.ops.ssim import ssim

    def grad(x, y):
        x = x.detach().clone().requires_grad_(True)
        ssim(x, y).backward()
        return x.grad

    g_card = grad(img, gt)
    g64 = grad(img.double(), gt.double())
    g_cpu = grad(img.cpu(), gt.cpu()).to(img.device)
    scale = g64.abs().max()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / scale)

    card_cpu = rel(g_card, g_cpu)
    log(f"phase 3: SSIM gradient, max|d| / max|g float64| ({float(scale):.3e}): card float32 "
        f"vs CPU float32 {card_cpu:.3e} (bar {TOL_SSIM_GRAD_REL}); card float32 vs float64 "
        f"{rel(g_card, g64):.3e}; CPU float32 vs float64 {rel(g_cpu, g64):.3e}")
    if not card_cpu <= TOL_SSIM_GRAD_REL:
        raise AssertionError(f"SSIM gradient on the card off by {card_cpu:.3e} of its scale")
    return card_cpu


def write_dataset(model, src, dst, cameras, poses):
    """COLMAP text model, ground-truth PNGs rendered by the port, and the PLY."""
    from PIL import Image
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(src, "images"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {WIDTH} {HEIGHT} {FOCAL_X!r} {FOCAL_Y!r} {WIDTH / 2} {HEIGHT / 2}\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("1 0.0 0.0 3.5 128 128 128 0.1\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for i, ((q, t), cam) in enumerate(zip(poses, cameras)):
            name = f"view{i}.png"
            f.write(f"{i + 1} {' '.join(map(repr, q.tolist()))} "
                    f"{' '.join(map(repr, t.tolist()))} 1 {name}\n0.0 0.0 -1\n")
            with torch.no_grad():
                img = torch.clamp(model(cam)["render"], 0, 1)
            arr = (img * 255).to(torch.uint8).cpu().numpy().transpose(1, 2, 0)
            Image.fromarray(arr).save(os.path.join(src, "images", name))
    model.save_ply(os.path.join(dst, "point_cloud", "iteration_1", "point_cloud.ply"))


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        return run(tmp)


def run(tmp):
    from reduced_3dgs_torch import render
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.dataset.dataset import CameraDataset, prepare_dataset
    from reduced_3dgs_torch.ops.rasterize import _build, common, tiled
    from reduced_3dgs_torch.importance import BaseImportancePruningTrainer, prune_gaussians
    from reduced_3dgs_torch.ops.rasterize.composite import (CompositeSorted, composite_bwd,
                                                            composite_bwd_plain, composite_fwd,
                                                            composite_fwd_plain,
                                                            composite_fwd_stats,
                                                            composite_fwd_stats_plain,
                                                            pack_fields)
    from reduced_3dgs_torch.shculling import (SHCullingTrainerWrapper, VariableSHGaussianModel,
                                              cull_sh_bands)
    from reduced_3dgs_torch.train import training
    from reduced_3dgs_torch.trainer import Trainer

    dev = torch.device("cuda")
    wrappers = {"composite_fwd": composite_fwd, "composite_fwd_stats": composite_fwd_stats,
                "composite_bwd": composite_bwd}
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- phase 0
    card = card_name()
    log(card)
    log(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- phase 1
    t0 = time.perf_counter()
    _build.build_libraries(_build.SOURCES)
    for name in _build.SOURCES:
        _build.load_library(name)
    log(f"phase 1: built and loaded {list(_build.SOURCES)} (launchers "
        f"{sorted(_build.ARGTYPES)}) in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for kernel, u in sorted(_build.resource_usage(name).items()):
            log(f"phase 1: {kernel} ({name}.cu): {u['registers']} registers, "
                f"{u['smem_bytes']} B static shared memory, spill stores "
                f"{u['spill_stores']} B, spill loads {u['spill_loads']} B, stack "
                f"{u['stack_bytes']} B")

    # ---------------------------------------------------------------- phase 2
    params = bench_scene(0)
    params_p = perturbed(params)
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    model_p = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    poses = view_poses()
    cameras = [view_camera(pose, dev) for pose in poses]
    loss_cam = view_camera(poses[0], dev, bg_color=LOSS_BG)
    log(f"phase 2: bench scene N={model.num_points} at {HEIGHT}x{WIDTH}, "
        f"{N_VIEWS} views, SH degree {model.max_sh_degree}; perturbed copy for training")

    # ---------------------------------------------------------------- phase 3
    with torch.no_grad():
        bench = compare_compositor("bench", model, cameras[0])
        per_tile = (bench["inputs"][2] - bench["inputs"][1]).double()
        log(f"phase 3 [bench]: entries per tile over {per_tile.numel()} tiles: mean "
            f"{float(per_tile.mean()):.2f}, p99 {float(per_tile.quantile(0.99)):.2f}, max "
            f"{int(per_tile.max())}")
        opaque_params = dict(params, opacity=np.full_like(params["opacity"], 8.0))
        opaque_model = VariableSHGaussianModel(3, device=dev).load_numpy(opaque_params)
        opaque = compare_compositor("opaque", opaque_model, cameras[0])
        if opaque["latched"] == 0:
            raise AssertionError("opaque scene: no pixel latched")
        culled_params = dict(params, xyz=params["xyz"] * np.float32(-1.0))
        culled = compare_compositor(
            "culled", VariableSHGaussianModel(3, device=dev).load_numpy(culled_params),
            cameras[0])
        if culled["k"] != 0 or culled["empty"] != culled["tiles"]:
            raise AssertionError("culled scene: expected every tile empty")
        stats_bench = compare_stats("bench", bench)
        stats_opaque = compare_stats("opaque", opaque)
        stats_culled = compare_stats("culled", culled)
        if stats_culled["per_gaussian"].abs().max() != 0:
            raise AssertionError("culled scene: expected all-zero statistics")
        log(f"phase 3 [culled]: per-Gaussian statistics all zero over {culled['n']} Gaussians")
        stats_max_abs_err = max(c["max_abs_err"] for c in (stats_bench, stats_opaque,
                                                          stats_culled))
        del stats_opaque, stats_culled

        gt_loss = torch.clamp(model(loss_cam)["render"], 0, 1)
        real = loss_cotangents(model_p, loss_cam, gt_loss)
        if not real["g_t"].abs().max() > 0:
            raise AssertionError("the loss cotangent of final_T is zero")
        gen = torch.Generator(device=dev).manual_seed(11)

        def random_cotangents(case):
            t = case["inputs"][1].numel()
            return (torch.randn((t, 256, 4), device=dev, generator=gen),
                    torch.randn((t, 256, 1), device=dev, generator=gen))

        bwd_real = compare_backward("bench, loss cotangents", real, real["g_color4"],
                                    real["g_t"])
        bwd_rand = compare_backward("bench, random cotangents", bench,
                                    *random_cotangents(bench))
        bwd_opaque = compare_backward("opaque, random cotangents", opaque,
                                      *random_cotangents(opaque))
        bwd_culled = compare_backward("culled, random cotangents", culled,
                                      *random_cotangents(culled))
        if bwd_culled["grads"].numel() != 0:
            raise AssertionError("culled scene: expected no entries")
        culled_dfields = torch.zeros((10, culled["n"]), device=dev).index_add_(
            1, culled["s_gidx"], bwd_culled["grads"])
        if culled_dfields.abs().max() != 0:
            raise AssertionError("culled scene: expected all-zero gradients")
        log(f"phase 3 [culled]: per-Gaussian gradients all zero over {culled['n']} Gaussians")
        bwd_max_abs_err = max(b["max_abs_err"] for b in (bwd_real, bwd_rand, bwd_opaque,
                                                          bwd_culled))
        del bwd_rand, bwd_opaque, bwd_culled, opaque_model
    check_ssim_gradient(torch.clamp(model_p(loss_cam)["render"].detach(), 0, 1), gt_loss)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 4
    src, dst = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
    write_dataset(model, src, dst, cameras, poses)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    render.main(["-s", src, "-d", dst, "-i", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    render_launches = {name: fn.launches for name, fn in wrappers.items()}
    with open(os.path.join(dst, "metrics.json")) as f:
        metrics = json.load(f)
    psnrs = [m["psnr"] for m in metrics["per_image"]]
    log(f"phase 4: render.main on {len(psnrs)} views in {wall:.2f} s; psnr {psnrs} "
        f"ssim {[m['ssim'] for m in metrics['per_image']]} "
        f"n_points {metrics['summary']['n_points']} launches {render_launches}")
    if len(psnrs) != N_VIEWS or min(psnrs) < MIN_PSNR_DB or not all(map(math.isfinite, psnrs)):
        raise AssertionError(f"render CLI PSNR below {MIN_PSNR_DB} dB: {psnrs}")
    if metrics["summary"]["n_points"] != N_GAUSSIANS:
        raise AssertionError(f"n_points {metrics['summary']['n_points']}")
    if render_launches != {"composite_fwd": N_VIEWS, "composite_fwd_stats": 0,
                           "composite_bwd": 0}:
        raise AssertionError(f"render path launched {render_launches}, expected "
                             f"{N_VIEWS} forward and no backward compositor")

    # ---------------------------------------------------------------- phase 5
    e, rs, re, tiles_x = bench["inputs"]
    kernel_ms = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    plain_ms = cuda_ms(lambda: composite_fwd_plain(e, rs, re, tiles_x))
    kernel_ms_2 = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    latch, start, end = bench["latch"][..., 0].long(), rs.long()[:, None], re.long()[:, None]
    scanned = int((torch.minimum(latch + 1, end) - start).clamp(min=0).sum())
    n_bytes = e.numel() * 4 + 2 * rs.numel() * 4 + rs.numel() * 256 * (16 + 4 + 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = scanned * OPS_PER_SCANNED_PAIR / PEAK_F32_OPS_PER_S * 1e3
    fwd_bound = max(bytes_ms, ops_ms)
    fwd_bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_fwd kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f}), "
        f"plain {plain_ms:.4f} ms, K={bench['k']}, scanned pairs {scanned}, "
        f"bytes {n_bytes}, bound {fwd_bound:.4f} ms "
        f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); share of the bound "
        f"{fwd_bound / kernel_ms:.4f}")

    r_e, r_rs, r_re, r_tx = real["inputs"]
    bwd_args = (r_e, r_rs, r_re, r_tx, real["final_t"], real["latch"], real["g_color4"],
                real["g_t"])
    bwd_ms = cuda_ms(lambda: composite_bwd(*bwd_args))
    bwd_plain_ms = cuda_ms(lambda: composite_bwd_plain(*bwd_args))
    bwd_ms_2 = cuda_ms(lambda: composite_bwd(*bwd_args))
    bwd_pairs, bwd_contrib = backward_pairs(r_e, r_rs, r_re, r_tx, real["latch"])
    t_tiles = r_rs.numel()
    # e read and the gradients written (40 B per entry each), the ranges, and
    # per pixel final_T, latch, g_color4 and g_T (28 B).
    bwd_bytes = 2 * r_e.numel() * 4 + 2 * t_tiles * 4 + t_tiles * 256 * (4 + 4 + 16 + 4)
    bwd_bytes_ms = bwd_bytes / PEAK_BYTES_PER_S * 1e3
    bwd_ops = bwd_pairs * OPS_PER_SCANNED_PAIR + bwd_contrib * OPS_PER_CONTRIBUTING_PAIR
    bwd_ops_ms = bwd_ops / PEAK_F32_OPS_PER_S * 1e3
    bwd_bound = max(bwd_bytes_ms, bwd_ops_ms)
    bwd_bound_by = "bytes" if bwd_bytes_ms >= bwd_ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_bwd kernel {bwd_ms:.4f} ms (again {bwd_ms_2:.4f}), "
        f"plain {bwd_plain_ms:.4f} ms, K={real['k']}, pairs before the latch {bwd_pairs}, "
        f"of them contributing {bwd_contrib}, operations {bwd_ops}, bytes {bwd_bytes}, bound {bwd_bound:.4f} ms "
        f"(bytes {bwd_bytes_ms:.4f}, operations {bwd_ops_ms:.4f}); share of the bound "
        f"{bwd_bound / bwd_ms:.4f}")
    del bwd_args

    # The statistics compositor at the bench scene, camera 0, beside B1 again.
    stats_ms = cuda_ms(lambda: composite_fwd_stats(e, rs, re, tiles_x))
    stats_plain_ms = cuda_ms(lambda: composite_fwd_stats_plain(e, rs, re, tiles_x))
    stats_ms_2 = cuda_ms(lambda: composite_fwd_stats(e, rs, re, tiles_x))
    kernel_ms_3 = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    stats_contrib = stats_bench["contributing"]
    # B1's bytes and 16 B per entry of statistics written.
    stats_bytes = n_bytes + 4 * e.shape[1] * 4
    stats_bytes_ms = stats_bytes / PEAK_BYTES_PER_S * 1e3
    stats_ops = scanned * OPS_PER_SCANNED_PAIR + stats_contrib * OPS_PER_STATS_CONTRIBUTING_PAIR
    stats_ops_ms = stats_ops / PEAK_F32_OPS_PER_S * 1e3
    stats_bound = max(stats_bytes_ms, stats_ops_ms)
    stats_bound_by = "bytes" if stats_bytes_ms >= stats_ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_fwd_stats kernel {stats_ms:.4f} ms (again "
        f"{stats_ms_2:.4f}), plain {stats_plain_ms:.4f} ms, composite_fwd again "
        f"{kernel_ms_3:.4f} ms; K={bench['k']}, scanned pairs {scanned}, of them contributing "
        f"{stats_contrib}, operations {stats_ops}, bytes {stats_bytes}, bound "
        f"{stats_bound:.4f} ms (bytes {stats_bytes_ms:.4f}, operations {stats_ops_ms:.4f}); "
        f"share of the bound {stats_bound / stats_ms:.4f}")

    # The two reduction events over the 4 views at the bench scene: an
    # importance-pruning sweep (4 statistics renders and the scores) and an
    # SH cull (8 statistics renders), each cull from the same starting state.
    views = CameraDataset(cameras)

    def prune():  # ImportancePruner's default type and thresholds
        return prune_gaussians(model, views, prune_type="comprehensive", prune_percent=0.1,
                               prune_thr_v_important_score=3.0, prune_thr_count=1,
                               prune_thr_T_alpha=1, prune_thr_T_alpha_avg=0.001)

    with torch.no_grad():
        prune_ms = cuda_ms(prune)
        n_pruned = int(prune().sum())
    cull_model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    start_dc = cull_model._features_dc.detach().clone()
    start_rest = cull_model._features_rest.detach().clone()

    def reset_cull_model():
        with torch.no_grad():
            cull_model._features_dc.copy_(start_dc)
            cull_model._features_rest.copy_(start_rest)
        cull_model.init_degrees()

    def cull():  # SHCuller's default thresholds
        cull_sh_bands(cull_model, views, threshold=6, std_threshold=0.04)

    cull_ms = cuda_ms(cull, setup=reset_cull_model)
    cull_busy = device_busy(lambda: (reset_cull_model(), cull()))
    degree_hist = torch.bincount(cull_model._degrees.long(), minlength=4).tolist()
    log(f"phase 5 [{card}]: prune_gaussians over {len(views)} views {prune_ms:.4f} ms "
        f"(ImportancePruner's defaults: {n_pruned} of {model.num_points} to prune); "
        f"cull_sh_bands over {len(views)} views {cull_ms:.4f} ms (SHCuller's defaults; "
        f"degrees 0-3 after: {degree_hist})")
    print_busy(card, "SH cull", cull_busy)
    del cull_model, start_dc, start_rest

    stages = {"preprocess": [], "binning_sort": [], "gather_kernel": [], "assembly": []}
    camera = cameras[0]
    with torch.no_grad():
        for it in range(REPEATS + 3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            settings = model.render_settings(camera)
            tx, ty = common.tile_grid(settings)
            pre = common.preprocess(*model.render_array_args(), settings)
            ev[1].record()
            ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched,
                                     pre.depths, tx, ty)
            ev[2].record()
            color4, final_t = CompositeSorted.apply(
                pack_fields(pre), ent["s_gidx"], ent["range_start"], ent["range_end"], tx)
            ev[3].record()
            out = tiled._assemble_outputs(color4, final_t, pre, settings, tx, ty,
                                          HEIGHT, WIDTH, ent["num_rendered"])
            ev[4].record()
            ev[4].synchronize()
            if it >= 3:
                for i, key in enumerate(stages):
                    stages[key].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: statistics.median(v) for k, v in stages.items()}
    with torch.no_grad():
        whole_ms = cuda_ms(lambda: model(camera))
    log(f"phase 5 [{card}]: render per image {whole_ms:.4f} ms; stage medians "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    with torch.no_grad():
        print_busy(card, "render", device_busy(lambda: model(camera)))
    if not torch.isfinite(out["render"]).all() or out["render"].shape != (3, HEIGHT, WIDTH):
        raise AssertionError("render output is not a finite [3, H, W] image")

    # One training step at the bench scene: the perturbed model against the
    # unperturbed scene's render at camera 0.
    with torch.no_grad():
        gt0 = torch.clamp(model(camera)["render"], 0, 1)
    step_cam = build_camera(HEIGHT, WIDTH, camera.FoVx, camera.FoVy, R=camera.R, T=camera.T,
                            ground_truth_image=gt0, device=dev)
    step_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    step_trainer = Trainer(step_model, CameraDataset([step_cam]))
    step_model.active_sh_degree = 3
    step_ms = cuda_ms(lambda: step_trainer.step(step_cam))
    step_stages = {"forward_loss": [], "backward": [], "adam_stats": []}
    loss_fn = step_trainer.loss_pure()
    for it in range(REPEATS + 3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        step_trainer.maybe_advance_schedules()
        loss, out_s, offset = step_trainer.forward_loss(loss_fn, step_cam, {})
        ev[1].record()
        loss.backward()
        ev[2].record()
        step_trainer.optimizer_step(out_s, offset)
        step_trainer.curr_step += 1
        ev[3].record()
        ev[3].synchronize()
        if it >= 3:
            for i, key in enumerate(step_stages):
                step_stages[key].append(ev[i].elapsed_time(ev[i + 1]))
    step_split = {k: statistics.median(v) for k, v in step_stages.items()}
    step_busy = device_busy(lambda: step_trainer.step(step_cam))
    b3_share = sum(ms for key, ms in step_busy[4].items() if "composite_bwd" in key)
    log(f"phase 5 [{card}]: training step {step_ms:.4f} ms (Trainer.step, N={N_GAUSSIANS}, "
        f"{HEIGHT}x{WIDTH}, SH degree 3); stage medians "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in step_split.items())
        + f"; composite_bwd device time per step under the profiler {b3_share:.4f} ms")
    print_busy(card, "training step", step_busy)
    if not math.isfinite(float(loss.detach())):
        raise AssertionError("training step loss is not finite")
    del step_trainer, step_model, out_s, offset, loss
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 6
    dataset = prepare_dataset(src)
    train_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    trainer = Trainer(train_model, dataset)
    train_model.active_sh_degree = 3
    out_dir = os.path.join(tmp, "train")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = training(dataset, train_model, trainer, None, out_dir, iteration=TRAIN_STEPS,
                      save_iterations=[TRAIN_STEPS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    first, last = statistics.mean(values[:4]), statistics.mean(values[-4:])
    log(f"phase 6: training() {TRAIN_STEPS} steps on {len(dataset)} views in {wall:.2f} s; "
        f"losses {values}; mean of the first 4 {first:.6f}, of the last 4 {last:.6f}; "
        f"launches {launches}")
    if len(values) != TRAIN_STEPS or not all(map(math.isfinite, values)):
        raise AssertionError(f"training losses are not all finite: {values}")
    if not last < first:
        raise AssertionError("training did not reduce the loss")
    if launches != {"composite_fwd": TRAIN_STEPS, "composite_fwd_stats": 0,
                    "composite_bwd": TRAIN_STEPS}:
        raise AssertionError(f"training launched {launches}, expected {TRAIN_STEPS} of the "
                             "forward and backward compositors and no statistics compositor")
    saved = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(out_dir, "point_cloud", f"iteration_{TRAIN_STEPS}", "point_cloud.ply"))
    finite = all(bool(torch.isfinite(p).all()) for p in saved.param_dict().values())
    log(f"phase 6: saved PLY holds {saved.num_points} points, finite {finite}; "
        f"cameras.json {os.path.exists(os.path.join(out_dir, 'cameras.json'))}")
    if saved.num_points != N_GAUSSIANS or not finite:
        raise AssertionError("the trained PLY does not load back whole and finite")

    del trainer, train_model, saved
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 7
    red_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    red_trainer = SHCullingTrainerWrapper(BaseImportancePruningTrainer, red_model, dataset,
                                          **REDUCTION_CONFIG)
    events = []
    take_step = red_trainer.step

    def step_and_watch(camera):
        """A step; around the steps where an event fires, N, the degrees'
        histogram and the row count of every per-Gaussian tensor."""
        fires = red_trainer.curr_step + 1 in PRUNE_STEPS + CULL_STEPS
        if fires:
            n0 = red_model.num_points
            hist0 = torch.bincount(red_model._degrees.long(), minlength=4).tolist()
        out = take_step(camera)
        if fires:
            rows = {f"{g}/{k}": v.shape[0] for g, t in red_trainer.engine.state_trees().items()
                    for k, v in t.items()}
            events.append(dict(step=red_trainer.curr_step, n_before=n0,
                               n_after=red_model.num_points, degrees_before=hist0,
                               degrees_after=torch.bincount(red_model._degrees.long(),
                                                            minlength=4).tolist(),
                               rows=sorted(set(rows.values()))))
        return out

    red_trainer.step = step_and_watch
    red_dir = os.path.join(tmp, "reduction")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    red_losses = training(dataset, red_model, red_trainer, None, red_dir,
                          iteration=REDUCTION_STEPS, save_iterations=[])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    red_launches = {name: fn.launches for name, fn in wrappers.items()}
    red_values = torch.stack(red_losses).cpu().tolist()
    for ev in events:
        log(f"phase 7: after step {ev['step']}: N {ev['n_before']} -> {ev['n_after']}, "
            f"degrees 0-3 {ev['degrees_before']} -> {ev['degrees_after']}, rows of every "
            f"per-Gaussian tensor {ev['rows']}")
    log(f"phase 7: training() {REDUCTION_STEPS} steps with importance pruning and SH culling "
        f"on {len(dataset)} views in {wall:.2f} s; losses {red_values}; launches {red_launches}")
    expected = {"composite_fwd": REDUCTION_STEPS, "composite_bwd": REDUCTION_STEPS,
                "composite_fwd_stats": len(dataset) * (len(PRUNE_STEPS) + 2 * len(CULL_STEPS))}
    if red_launches != expected:
        raise AssertionError(f"reduction path launched {red_launches}, expected {expected}")
    if [ev["step"] for ev in events] != sorted(PRUNE_STEPS + CULL_STEPS):
        raise AssertionError(f"events fired after steps {[ev['step'] for ev in events]}")
    for ev in events:
        if ev["rows"] != [ev["n_after"]]:
            raise AssertionError(f"step {ev['step']}: per-Gaussian tensors have rows "
                                 f"{ev['rows']}, the model {ev['n_after']}")
        if ev["step"] in PRUNE_STEPS and not ev["n_after"] < ev["n_before"]:
            raise AssertionError(f"step {ev['step']}: the prune did not lower N")
        if ev["step"] in CULL_STEPS and not (sum(ev["degrees_after"][:3])
                                             > sum(ev["degrees_before"][:3])):
            raise AssertionError(f"step {ev['step']}: the cull lowered no degree")
    if len(red_values) != REDUCTION_STEPS or not all(map(math.isfinite, red_values)):
        raise AssertionError(f"reduction losses are not all finite: {red_values}")
    red_saved = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(red_dir, "point_cloud", f"iteration_{REDUCTION_STEPS}", "point_cloud.ply"))
    log(f"phase 7: saved PLY holds {red_saved.num_points} points (model "
        f"{red_model.num_points}, from {N_GAUSSIANS})")
    if red_saved.num_points != red_model.num_points or not red_model.num_points < N_GAUSSIANS:
        raise AssertionError("the reduced PLY does not hold the pruned model")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_fwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300",
        "launches": red_launches["composite_fwd"],
        "max_abs_err": bench["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "library_ms": None,
    }, {
        "name": "composite_fwd_stats",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_fwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300",
        "launches": red_launches["composite_fwd_stats"],
        "max_abs_err": stats_max_abs_err,
        "ms": stats_ms,
        "plain_ms": stats_plain_ms,
        "bound_ms": stats_bound,
        "bound_by": stats_bound_by,
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_bwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:502",
        "launches": red_launches["composite_bwd"],
        "max_abs_err": bwd_max_abs_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
