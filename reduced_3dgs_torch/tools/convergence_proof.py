"""Convergence and compression proof on a procedural scene (counterpart of
tools/convergence_proof.py).

The reference's claim is "train a scene, keep about half the primitives,
store it several times smaller, keep the PSNR". No dataset is needed: the
scene is parametric surfaces (a torus, a sphere, a checkered ground) sampled
into a ground-truth Gaussian cloud and rendered from a camera orbit, with
seeded sensor noise on the captures. The tool trains the flagship mode
(``densify-pruning-shculling``: densification, mercy and importance
pruning, the SH cull) from a sparse noisy subsample, saves the raw and the
vector-quantized PLY, trains an unpruned baseline
(``OpacityResetDensificationTrainer`` over a plain ``GaussianModel``) on the
same scene and schedule, and writes PSNR, point counts and on-disk sizes
against four bars.

Usage (one NVIDIA GPU; ``full`` is the proof, ``large`` peaks above 500k):
    python -m reduced_3dgs_torch.tools.convergence_proof --preset full
On the CPU, at a toy size:
    python -m reduced_3dgs_torch.tools.convergence_proof --preset smoke --device cpu

Everything goes under ``--workdir`` (a fresh temporary directory by
default): the periodic checkpoints and the partial records that name them
(``reduced.partial``, ``baseline.partial``), the two PLYs, the baseline's
cache, and the result (``--out``, default ``<workdir>/result.json``). Given
the same ``--workdir`` and the same configuration again, a cut run resumes
from its last checkpoint with the same losses; a record of another
configuration is ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..dataset.camera import build_camera
from ..dataset.dataset import CameraDataset
from ..models.gaussian_model import GaussianModel
from ..prepare import modes
from ..quantization import ExcludeZeroSHQuantizer
from ..shculling import VariableSHGaussianModel
from ..trainer import OpacityResetDensificationTrainer
from ..trainer.checkpoint import load_checkpoint, save_checkpoint
from ..utils.debug import trainer_snapshot
from ..utils.device import resolve_device
from ..utils.math import psnr

RAW_PLY = "point_cloud.ply"
QUANTIZED_PLY = "point_cloud_quantized.ply"
PROOF_PRESETS = ("full", "mid", "large")
BARS = {"psnr_final_min": 24.0, "psnr_gain_min": 4.0,
        "reduction_vs_unpruned_min": 0.3, "size_ratio_max": 0.3}


# --------------------------------------------------------------- GT scene
def surface_cloud(n: int, seed: int = 0) -> dict:
    """Sample Gaussians on parametric surfaces (torus + sphere + ground).

    Colors are smooth functions of position so the SH basis can represent
    them; scales follow local sample spacing so the surfaces close up."""
    rng = np.random.default_rng(seed)
    n_t, n_s = int(n * 0.45), int(n * 0.30)
    n_g = n - n_t - n_s

    u = rng.uniform(0, 2 * np.pi, n_t)
    v = rng.uniform(0, 2 * np.pi, n_t)
    R0, r0 = 1.6, 0.55
    torus = np.stack([(R0 + r0 * np.cos(v)) * np.cos(u),
                      r0 * np.sin(v),
                      (R0 + r0 * np.cos(v)) * np.sin(u)], -1)
    tor_col = np.stack([0.5 + 0.45 * np.cos(u),
                        0.5 + 0.45 * np.sin(2 * v),
                        0.5 + 0.45 * np.sin(u + v)], -1)

    dirs = rng.normal(size=(n_s, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sphere = np.array([0.0, 1.4, 0.0]) + 0.8 * dirs
    sph_col = 0.5 + 0.45 * dirs[:, [1, 2, 0]]

    gx = rng.uniform(-4, 4, n_g)
    gz = rng.uniform(-4, 4, n_g)
    ground = np.stack([gx, np.full(n_g, -1.2), gz], -1)
    checker = (np.floor(gx) + np.floor(gz)) % 2
    gnd_col = np.stack([0.25 + 0.5 * checker,
                        0.35 + 0.3 * checker,
                        0.45 - 0.2 * checker], -1)

    xyz = np.concatenate([torus, sphere, ground]).astype(np.float32)
    col = np.clip(np.concatenate([tor_col, sph_col, gnd_col]),
                  0.02, 0.98).astype(np.float32)
    # local spacing ~ sqrt(area/n); denser surfaces -> smaller splats
    area = np.array([4 * np.pi**2 * R0 * r0] * n_t
                    + [4 * np.pi * 0.8**2] * n_s + [64.0] * n_g)
    counts = np.array([n_t] * n_t + [n_s] * n_s + [n_g] * n_g)
    spacing = np.sqrt(area / counts).astype(np.float32)
    return {"xyz": xyz, "col": col, "spacing": spacing}


def orbit_cameras(n_cams: int, hw, device="cuda") -> list:
    """``n_cams`` cameras on an orbit of radius 5.2 around the origin, at an
    elevation that waves three times per turn, 65° of horizontal FoV."""
    H, W = hw
    fovx = math.radians(65)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cams = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        el = 0.25 + 0.2 * math.sin(3 * ang)
        C = np.array([5.2 * math.cos(ang) * math.cos(el),
                      5.2 * math.sin(el),
                      5.2 * math.sin(ang) * math.cos(el)], np.float32)
        fwd = -C / np.linalg.norm(C)
        up = np.array([0, 1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R_w2c = np.stack([right, up2, fwd])              # rows = cam axes
        tvec = -R_w2c @ C
        cams.append(build_camera(H, W, fovx, fovy, R=R_w2c.T, T=tvec, device=device))
    return cams


PRESETS = {
    # GT gaussians, init points, resolution, steps, cameras, GT noise,
    # densify gradient threshold. The init is sparse against the GT (like
    # the SfM seeds the reference trains from), so densification has room
    # to grow and the pruners something redundant to remove; full and
    # large use the reference's published truck threshold (1e-4) and sensor
    # noise on the captures, where densification over-splits and the
    # reduction stages earn their keep.
    "full": dict(n_gt=120_000, n_init=6_000, hw=(544, 976), iters=2000,
                 cams=24, noise=0.015, grad_thr=1e-4),
    # A truck-like peak primitive count (>= 500k).
    "large": dict(n_gt=1_000_000, n_init=100_000, hw=(544, 976), iters=3000,
                  cams=24, noise=0.015, grad_thr=1e-4),
    # Long enough for the schedule to breathe, small enough for the CPU.
    "mid": dict(n_gt=20_000, n_init=6_000, hw=(136, 244), iters=900),
    "smoke": dict(n_gt=4_000, n_init=1_500, hw=(64, 96), iters=60),
}


@dataclasses.dataclass
class Scene:
    cameras: list               # with their noisy ground-truth images
    dataset: CameraDataset
    points: np.ndarray          # [n_init, 3] float64, the noisy subsample
    colors: np.ndarray          # [n_init, 3] float64 in [0, 1]
    model: VariableSHGaussianModel
    rng: np.random.Generator    # goes on to draw the view shuffles


@torch.no_grad()
def build_scene(cfg: dict, n_cams: int, noise: float, device="cuda") -> Scene:
    """The ground-truth cloud rendered from the orbit (clipped to [0, 1],
    then seeded sensor noise), and the training start: a noisy subsample of
    the cloud through ``create_from_pcd`` at the maximum SH degree."""
    device = resolve_device(device)
    cloud = surface_cloud(cfg["n_gt"])
    n = cloud["xyz"].shape[0]
    SH_C0 = 0.28209479177387814
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    # GT model: opaque, isotropic splats sized by local spacing.
    gt = GaussianModel(3, device=device).load_numpy(dict(
        xyz=cloud["xyz"],
        features_dc=((cloud["col"] - 0.5) / SH_C0)[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.log(cloud["spacing"])[:, None].repeat(3, 1),
        rotation=rotation,
        opacity=np.full((n, 1), 6.0, np.float32),      # sigmoid ~ 0.998
    ))
    cams = orbit_cameras(n_cams, cfg["hw"], device)
    gts = [torch.clamp(gt(c)["render"], 0, 1).cpu().numpy() for c in cams]
    del gt
    if noise > 0.0:
        # Sensor noise on the captures (seeded): training and evaluation
        # both see the noisy images, like real photographs.
        nrng = np.random.default_rng(123)
        gts = [np.clip(g + nrng.normal(0, noise, g.shape), 0, 1).astype(np.float32)
               for g in gts]
    cams = [dataclasses.replace(c, ground_truth_image=torch.from_numpy(g).to(device))
            for c, g in zip(cams, gts)]
    ds = CameraDataset(cams)

    # Training init: noisy subsample of the GT cloud (synthetic SfM points).
    rng = np.random.default_rng(7)
    sel = rng.choice(n, cfg["n_init"], replace=False)
    pts = cloud["xyz"][sel] + rng.normal(0, 0.02, (cfg["n_init"], 3))
    cols = np.clip(cloud["col"][sel] + rng.normal(0, 0.08, (cfg["n_init"], 3)), 0, 1)
    model = VariableSHGaussianModel(3, device=device)
    model.create_from_pcd(pts.astype(np.float32), cols.astype(np.float32),
                          scene_extent=float(ds.scene_extent()))
    model.init_degrees()
    return Scene(cams, ds, pts, cols, model, rng)


def schedule(cfg: dict, scene_extent: float):
    """(the flagship's kwargs, the unpruned baseline's kwargs): the
    reference's 30k-step schedule scaled to ``cfg["iters"]``."""
    it = cfg["iters"]
    s = it / 30000.0                                   # schedule scale factor

    def sc(x):
        return max(1, int(round(x * s)))

    extra = {"densify_grad_threshold": cfg["grad_thr"]} if "grad_thr" in cfg else {}
    baseline = dict(
        extra,
        scene_extent=scene_extent,
        densify_from_iter=sc(500), densify_until_iter=sc(15000),
        densify_interval=max(10, sc(100)),
        opacity_reset_interval=sc(3000),
        # The reference stops resets at densify_until: a reset at the final
        # step would wreck the final evaluation.
        opacity_reset_until_iter=sc(15000),
        prune_from_iter=sc(1000), prune_until_iter=sc(15000),
        prune_interval=max(10, sc(100)),
        iterations=it)
    flagship = dict(
        baseline,
        importance_prune_from_iter=sc(15000),
        importance_prune_until_iter=sc(20000),
        importance_prune_interval=max(10, (sc(20000) - sc(15000)) // 5),
        cull_at_steps=[sc(15000)])
    return flagship, baseline


def event_steps(trainer, iters: int) -> Dict[str, List[int]]:
    """Steps 1..iters after which each event of the trainer's chain fires,
    by the class that owns it (``SHCuller``, ``OpacityResetter``,
    ``BasePruner``, ``SplitCloneDensifier``, ``ImportancePruner``, ...)."""
    owners, t = [], trainer
    while t is not None:
        owners.append(t)
        d = getattr(t, "densifier", None)
        while d is not None:
            owners.append(d)
            d = getattr(d, "base_densifier", None)
        t = getattr(t, "base_trainer", None)
    return {type(o).__name__: [s for s in range(1, iters + 1) if o.fires(s)]
            for o in owners if hasattr(o, "fires")}


@torch.no_grad()
def eval_psnr(model, cams) -> float:
    """Mean over every ``len(cams) // 6``-th view of the per-channel mean
    PSNR against its (noisy) ground truth."""
    vals = []
    for c in cams[::max(1, len(cams) // 6)]:
        img = model(c)["render"]
        vals.append(float(psnr(img, c.ground_truth_image).mean()))
    return float(np.mean(vals))


def smi_line() -> Optional[str]:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` ("<name>, <limit> W"), or None without one."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def card_record(device: torch.device):
    """(device name, power limit): the card's name and ``nvidia-smi``'s
    power limit on CUDA, ("cpu", None) elsewhere."""
    if device.type != "cuda":
        return "cpu", None
    line = smi_line()
    return torch.cuda.get_device_name(device), (line.split(",")[-1].strip() if line else None)


def _write_json(path: str, obj):
    """Write ``obj`` whole or not at all (a cut leaves the last version)."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _checkpoint(trainer, workdir: str, tag: str, step: int, partial_path: str, record: dict):
    """Save the trainer under ``workdir`` as ``ckpt_<tag>_<step>.npz``, then
    ``record`` (naming that file) to ``partial_path``, then drop the older
    checkpoints: the record always names a whole checkpoint."""
    name = f"ckpt_{tag}_{step:06d}.npz"
    save_checkpoint(trainer, os.path.join(workdir, name))
    _write_json(partial_path, dict(record, checkpoint=name))
    for old in glob.glob(os.path.join(workdir, f"ckpt_{tag}_*.npz")):
        if os.path.basename(old) != name:
            os.remove(old)


def _saved_record(path: str, key: dict) -> Optional[dict]:
    """The record at ``path`` when it was written by a run of ``key``."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        record = json.load(f)
    return record if record.get("run") == key else None


def _train(trainer, ds, rng, iters: int, every: int, workdir: str, tag: str,
           partial_path: str, record: dict, saved: Optional[dict], on_step, on_row):
    """The loop both runs share: shuffle the views whenever ``step %
    len(views) == 1`` (from ``rng``), step on ``views[step % len(views)]``,
    and every ``every`` steps (and at the last) call ``on_row(step, loss)``,
    checkpoint and write ``record`` with the loop's state to
    ``partial_path``. From ``saved``, such a record, it first restores the
    checkpoint, the record, the view order and the generator's state."""
    order, start = list(range(len(ds))), 0
    if saved is not None:
        load_checkpoint(trainer, os.path.join(workdir, saved["checkpoint"]))
        record.update({k: v for k, v in saved.items() if k in record})
        rng.bit_generator.state = saved["rng"]
        order, start = saved["order"], saved["step"]
        print(f"{tag}: resumed at step {start} (n={trainer.model.num_points})", flush=True)
    for step in range(start + 1, iters + 1):
        if step % len(order) == 1:
            rng.shuffle(order)
        camera = ds[order[step % len(order)]]
        loss, _ = trainer.step(camera)
        record["n_points_peak"] = max(record["n_points_peak"], trainer.model.num_points)
        if on_step is not None:
            on_step(tag, step, trainer)
        if step % 10 == 0 and "n_points_trace_10step" in record:
            record["n_points_trace_10step"].append([step, trainer.model.num_points])
        if step % every == 0 or step == iters:
            loss_now = float(loss)
            if not math.isfinite(loss_now):
                path = trainer_snapshot(trainer.engine, "nonfinite_loss", camera,
                                        extra={"step": step, "loss": loss_now})
                raise RuntimeError(f"{tag}: non-finite loss {loss_now} at step {step}"
                                   + (f"; state dumped to {path}" if path else ""))
            on_row(step, loss_now)
            _checkpoint(trainer, workdir, tag, step, partial_path,
                        dict(record, step=step, order=order, rng=rng.bit_generator.state))


def run(cfg: dict, *, device="cuda", workdir: Optional[str] = None, out: Optional[str] = None,
        resume: bool = False, preset: Optional[str] = None,
        on_step: Optional[Callable] = None) -> dict:
    """Train the flagship and the unpruned baseline on the procedural scene
    of ``cfg`` (a ``PRESETS`` entry, optionally with ``cams`` and ``noise``
    set), write the result to ``out`` and return it.

    With ``resume``, each run continues from the checkpoint its partial
    record in ``workdir`` names (``reduced.partial``, ``baseline.partial``),
    and a finished baseline is read from ``baseline.json``, each only when
    written by a run of the same ``preset`` and configuration.
    ``on_step(tag, step, trainer)`` is called after every training step of
    both runs (``tag`` "reduced" or "baseline")."""
    device = resolve_device(device)
    t_start = time.time()
    workdir = workdir or tempfile.mkdtemp(prefix="convergence_proof_")
    os.makedirs(workdir, exist_ok=True)
    print(f"workdir {workdir}", flush=True)
    out = out or os.path.join(workdir, "result.json")
    n_cams, noise = cfg.get("cams", 4), cfg.get("noise", 0.0)
    it = cfg["iters"]
    every = max(1, it // 20)
    # What a record must have been written by to be resumed from (JSON's
    # view of it: tuples read back as lists).
    key = json.loads(json.dumps(dict(cfg, cams=n_cams, noise=noise, preset=preset)))

    scene = build_scene(cfg, n_cams, noise, device)
    ds, cams, model = scene.dataset, scene.cameras, scene.model
    extent = float(ds.scene_extent())
    flagship_kw, baseline_kw = schedule(cfg, extent)
    trainer = modes["densify-pruning-shculling"](model, ds, **flagship_kw)

    record = {"run": key, "psnr_init": None, "n_points_peak": model.num_points,
              "history": [], "n_points_trace_10step": []}
    partial = os.path.join(workdir, "reduced.partial")
    saved = _saved_record(partial, key) if resume else None
    if saved is None:
        record["psnr_init"] = eval_psnr(model, cams)
        print(f"init: psnr={record['psnr_init']:.2f} n={model.num_points}", flush=True)

    def reduced_row(step, loss):
        row = {"step": step, "loss": loss, "psnr": eval_psnr(model, cams),
               "n_points": model.num_points}
        record["history"].append(row)
        print(row, flush=True)

    _train(trainer, ds, scene.rng, it, every, workdir, "reduced", partial, record, saved,
           on_step, reduced_row)
    history = record["history"]

    # Save raw + quantized, compare on-disk size.
    raw_path, q_path = os.path.join(workdir, RAW_PLY), os.path.join(workdir, QUANTIZED_PLY)
    model.save_ply(raw_path)
    ExcludeZeroSHQuantizer().save_quantized(model, q_path)
    raw_sz, q_sz = os.path.getsize(raw_path), os.path.getsize(q_path)
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The unpruned vanilla baseline: the same scene and schedule, no
    # reduction. The reference's headline is "around half the primitives"
    # against it, not against the reduced run's own peak.
    bl_cache = os.path.join(workdir, "baseline.json")
    baseline = _saved_record(bl_cache, key) if resume else None
    if baseline is not None:
        print("loaded cached baseline:", baseline, flush=True)
    else:
        bmodel = GaussianModel(3, device=device).create_from_pcd(
            scene.points.astype(np.float32), scene.colors.astype(np.float32),
            scene_extent=extent)
        btrainer = OpacityResetDensificationTrainer(bmodel, ds, **baseline_kw)

        def baseline_row(step, loss):
            print(f"baseline step {step} n={bmodel.num_points}", flush=True)

        partial = os.path.join(workdir, "baseline.partial")
        _train(btrainer, ds, np.random.default_rng(11), it, every, workdir, "baseline",
               partial, {"run": key, "n_points_peak": 0},
               _saved_record(partial, key) if resume else None, on_step, baseline_row)
        baseline = {"run": key, "n_points_final": int(bmodel.num_points),
                    "psnr_final": round(eval_psnr(bmodel, cams), 2)}
        _write_json(bl_cache, baseline)
        print("baseline:", baseline, flush=True)
        del btrainer, bmodel

    final = history[-1]
    psnr0, n_peak = record["psnr_init"], record["n_points_peak"]
    name, power_limit = card_record(device)
    result = {
        "preset": preset,
        "scene": {"n_gt": cfg["n_gt"], "n_init": cfg["n_init"],
                  "resolution": list(cfg["hw"]), "n_cams": len(cams),
                  "iters": it, "gt_noise_sigma": noise,
                  "densify_grad_threshold": cfg.get("grad_thr", 2e-4)},
        "psnr_init": round(psnr0, 2),
        "psnr_final": round(final["psnr"], 2),
        "n_points_init": cfg["n_init"],
        "n_points_peak": int(n_peak),
        "n_points_final": int(final["n_points"]),
        "prune_ratio_vs_peak": round(1 - final["n_points"] / n_peak, 3),
        "n_points_unpruned_baseline": baseline["n_points_final"],
        "psnr_unpruned_baseline": baseline["psnr_final"],
        "reduction_vs_unpruned": round(
            1 - final["n_points"] / max(baseline["n_points_final"], 1), 3),
        "raw_ply_bytes": raw_sz,
        "quantized_ply_bytes": q_sz,
        "size_ratio": round(q_sz / raw_sz, 3),
        "wall_minutes": round((time.time() - t_start) / 60, 1),
        "device": name,
        "power_limit": power_limit,
        "history": history,
        "n_points_trace_10step": record["n_points_trace_10step"],
        "bars": dict(BARS),
        "bar_change_note": (
            "reduction_vs_unpruned_min is held against a vanilla run of the same "
            "scene and schedule, not against the reduced run's own peak: mercy "
            "pruning suppresses the peak during densification, so a share of the "
            "peak shrinks precisely when the reduction works better. "
            "prune_ratio_vs_peak is still reported."),
    }
    ok = (final["psnr"] >= BARS["psnr_final_min"]
          and final["psnr"] - psnr0 >= BARS["psnr_gain_min"]
          and result["reduction_vs_unpruned"] >= BARS["reduction_vs_unpruned_min"]
          and result["size_ratio"] <= BARS["size_ratio_max"])
    # smoke is too short for the schedule (resets leave no recovery room);
    # mid, full and large are real proofs.
    result["bars_ok"] = bool(ok) if preset in PROOF_PRESETS else None
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "history"}), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="full", choices=list(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cams", type=int, default=None,
                    help="override the preset's camera count")
    ap.add_argument("--noise", type=float, default=None,
                    help="override the preset's GT sensor-noise sigma")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints, PLYs and the result (default: a fresh temporary "
                         "directory); a cut run resumes from here")
    ap.add_argument("--out", default=None, help="result JSON (default <workdir>/result.json)")
    args = ap.parse_args(argv)
    cfg = dict(PRESETS[args.preset])
    if args.cams is not None:
        cfg["cams"] = args.cams
    if args.noise is not None:
        cfg["noise"] = args.noise
    return run(cfg, device=args.device, workdir=args.workdir, out=args.out, resume=True,
               preset=args.preset)


if __name__ == "__main__":
    main()
