#!/usr/bin/env python3
"""Smoke test of the PyTorch port (reduced_3dgs_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

  phase 0  card name, power limit and software versions
  phase 1  build every CUDA kernel from the sources in the checkout
  phase 2  the bench scene: 200,000 Gaussians at SH degree 3, 544x976
  phase 3  each kernel against its plain PyTorch version on the card, on
           the bench scene, an opaque scene and a fully culled scene
  phase 4  the render entry point (reduced_3dgs_torch.render.main) on a
           4-view COLMAP dataset of the bench scene, with the kernels'
           launch counts read around it
  phase 5  timing with CUDA events (median of 20 after warm-up)

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
N_VIEWS = 4
REPEATS = 20
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations every (pixel, entry) pair the compositor scans needs at
# least: offsets (2), quadratic form (9), exp (1), gate (1).
OPS_PER_SCANNED_PAIR = 13
# Colour and final_T agree to 1e-4 and depth to 5e-4: the bars the JAX
# package holds its own Pallas kernel to against its XLA path. The latch may
# flip where T (1 - alpha) sits on 1e-4, between sequential and log-space
# arithmetic, on at most 0.01% of pixels.
TOL_COLOR, TOL_DEPTH, MAX_LATCH_MISMATCH_SHARE = 1e-4, 5e-4, 1e-4
MIN_PSNR_DB = 40.0


def log(msg):
    print(msg, flush=True)


def bench_scene(seed=0, n=N_GAUSSIANS):
    """Raw parameters of the bench scene (bench.py's distribution) from numpy."""
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


def cuda_ms(fn, repeats=REPEATS, warmup=3):
    """Median milliseconds of fn() over `repeats` runs, each between two CUDA
    events, after `warmup` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(model, camera, renders=5):
    """Profile `renders` renders: (kernel launches per render, device busy
    ms per render, wall ms per render, top kernels by device time). Busy is
    the sum of device kernel and copy times on the one stream."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(camera)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(renders):
                model(camera)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in dev)
    top = sorted(dev, key=lambda a: -a.self_device_time_total)[:6]
    return (sum(a.count for a in dev) / renders, busy_us / 1e3 / renders, wall_ms / renders,
            [(a.key[:60], a.count // renders, a.self_device_time_total / 1e3 / renders)
             for a in top])


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
    return e, ent["range_start"], ent["range_end"], tiles_x, ent["num_rendered"]


def compare_compositor(name, model, camera):
    """Kernel against plain version on one scene; raises past the bars."""
    from reduced_3dgs_torch.ops.rasterize.composite import composite_fwd, composite_fwd_plain
    e, rs, re, tiles_x, k = sorted_entries(model, camera)
    kc, kt, kl = composite_fwd(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    pc, pt, pl = composite_fwd_plain(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    d_color = float((kc[..., :3] - pc[..., :3]).abs().max())
    d_depth = float((kc[..., 3] - pc[..., 3]).abs().max())
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
                tiles=rs.numel(), inputs=(e, rs, re, tiles_x), latch=kl)


def write_dataset(model, src, dst, cameras, poses, fx, fy):
    """COLMAP text model, ground-truth PNGs rendered by the port, and the PLY."""
    from PIL import Image
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(src, "images"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {WIDTH} {HEIGHT} {fx!r} {fy!r} {WIDTH / 2} {HEIGHT / 2}\n")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from reduced_3dgs_torch import render
    from reduced_3dgs_torch.dataset.camera import build_camera, focal2fov
    from reduced_3dgs_torch.dataset.colmap import qvec2rotmat
    from reduced_3dgs_torch.ops.rasterize import _build, common, tiled
    from reduced_3dgs_torch.ops.rasterize.composite import (CompositeSorted, composite_fwd,
                                                            composite_fwd_plain, pack_fields)
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- phase 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- phase 1
    t0 = time.perf_counter()
    for name in _build.ARGTYPES:
        _build.load_library(name)
    log(f"phase 1: built and loaded {sorted(_build.ARGTYPES)} in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 2
    params = bench_scene(0)
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    fx, fy = WIDTH / (2 * math.tan(FOVX / 2)), HEIGHT / (2 * math.tan(FOVY / 2))
    poses = view_poses()
    cameras = [build_camera(HEIGHT, WIDTH, focal2fov(fx, WIDTH), focal2fov(fy, HEIGHT),
                            R=qvec2rotmat(q).T, T=t, device=dev) for q, t in poses]
    log(f"phase 2: bench scene N={model.num_points} at {HEIGHT}x{WIDTH}, "
        f"{N_VIEWS} views, SH degree {model.max_sh_degree}")

    # ---------------------------------------------------------------- phase 3
    with torch.no_grad():
        bench = compare_compositor("bench", model, cameras[0])
        opaque_params = dict(params, opacity=np.full_like(params["opacity"], 8.0))
        opaque = compare_compositor(
            "opaque", VariableSHGaussianModel(3, device=dev).load_numpy(opaque_params),
            cameras[0])
        if opaque["latched"] == 0:
            raise AssertionError("opaque scene: no pixel latched")
        culled_params = dict(params, xyz=params["xyz"] * np.float32(-1.0))
        culled = compare_compositor(
            "culled", VariableSHGaussianModel(3, device=dev).load_numpy(culled_params),
            cameras[0])
        if culled["k"] != 0 or culled["empty"] != culled["tiles"]:
            raise AssertionError("culled scene: expected every tile empty")

    # ---------------------------------------------------------------- phase 4
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        write_dataset(model, src, dst, cameras, poses, fx, fy)
        wrappers = {"composite_fwd": composite_fwd}
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        render.main(["-s", src, "-d", dst, "-i", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        with open(os.path.join(dst, "metrics.json")) as f:
            metrics = json.load(f)
    psnrs = [m["psnr"] for m in metrics["per_image"]]
    log(f"phase 4: render.main on {len(psnrs)} views in {wall:.2f} s; psnr {psnrs} "
        f"ssim {[m['ssim'] for m in metrics['per_image']]} "
        f"n_points {metrics['summary']['n_points']} launches {launches}")
    if len(psnrs) != N_VIEWS or min(psnrs) < MIN_PSNR_DB or not all(map(math.isfinite, psnrs)):
        raise AssertionError(f"render CLI PSNR below {MIN_PSNR_DB} dB: {psnrs}")
    if metrics["summary"]["n_points"] != N_GAUSSIANS:
        raise AssertionError(f"n_points {metrics['summary']['n_points']}")
    if launches["composite_fwd"] != N_VIEWS:
        raise AssertionError(f"composite_fwd launched {launches['composite_fwd']} times "
                             f"on the main path, expected {N_VIEWS}")

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
    log(f"phase 5 [{card}]: composite_fwd kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f}), "
        f"plain {plain_ms:.4f} ms, K={bench['k']}, scanned pairs {scanned}, "
        f"bytes {n_bytes}, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")

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
    n_launch, busy_ms, wall_ms, top = device_busy(model, camera)
    if busy_ms > 0:
        log(f"phase 5 [{card}]: under torch.profiler, per render: {n_launch:.0f} device "
            f"kernels and copies, device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
            f"(idle share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log("phase 5: device busy share not measured (the profiler saw no device time)")
    if not torch.isfinite(out["render"]).all() or out["render"].shape != (3, HEIGHT, WIDTH):
        raise AssertionError("render output is not a finite [3, H, W] image")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_fwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300",
        "launches": launches["composite_fwd"],
        "max_abs_err": bench["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
