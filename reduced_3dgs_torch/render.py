"""Rendering and evaluation CLI (counterpart of reduced_3dgs_tpu/render.py).

Renders every camera of a COLMAP dataset from a trained model's PLY (or,
with ``--load_quantized``, its ``point_cloud_quantized.ply``), saves the
images and reports PSNR and SSIM, and LPIPS where its weights are there
(``metrics.lpips_available``). ``--load_camera`` takes the poses from a
cameras.json (a ``camera-*`` run's learned poses) and the images from the
dataset, by name. Runs on CUDA unless ``--device cpu`` is given; without a
GPU and without that flag it raises.

Usage: python -m reduced_3dgs_torch.render -s <colmap_dir> -d <model_dir> -i 30000
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .dataset.dataset import prepare_dataset
from .metrics.lpips import lpips, lpips_available
from .ops.ssim import ssim
from .quantization import ExcludeZeroSHQuantizer
from .shculling import VariableSHGaussianModel
from .utils.cache import enable_compile_cache
from .utils.device import resolve_device
from .utils.math import psnr


def save_image(path: str, img: torch.Tensor) -> None:
    from PIL import Image
    arr = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()
    Image.fromarray(arr.transpose(1, 2, 0)).save(path)


@torch.no_grad()
def render_dataset(model, dataset, out_dir: str, save_images: bool = True):
    """Render each camera; returns per-image {"psnr", "ssim"}, and "lpips"
    when its weights are available, where the camera has a ground-truth
    image."""
    os.makedirs(out_dir, exist_ok=True)
    metrics = []
    for i, camera in enumerate(dataset):
        img = model(camera)["render"]
        if save_images:
            save_image(os.path.join(out_dir, f"{i:05d}.png"), img)
        gt = camera.ground_truth_image
        if gt is not None:
            m = {
                "psnr": float(psnr(img, gt).mean()),
                "ssim": float(ssim(torch.clamp(img, 0, 1), gt)),
            }
            if lpips_available():
                m["lpips"] = float(lpips(torch.clamp(img, 0, 1), gt))
            metrics.append(m)
    return metrics


def main(argv=None):
    from argparse import ArgumentParser
    parser = ArgumentParser()
    parser.add_argument("--sh_degree", default=3, type=int)
    parser.add_argument("-s", "--source", required=True, type=str)
    parser.add_argument("-d", "--destination", required=True, type=str)
    parser.add_argument("-i", "--iteration", default=30000, type=int)
    parser.add_argument("--load_quantized", action="store_true")
    parser.add_argument("--load_camera", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--no_save_images", action="store_true")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    enable_compile_cache()

    it_dir = os.path.join(args.destination, "point_cloud", f"iteration_{args.iteration}")
    model = VariableSHGaussianModel(args.sh_degree, device=device)
    if args.load_quantized:
        ExcludeZeroSHQuantizer().load_quantized(
            model, os.path.join(it_dir, "point_cloud_quantized.ply"))
    else:
        model.load_ply(os.path.join(it_dir, "point_cloud.ply"))
    dataset = prepare_dataset(source=args.source, device=device, load_camera=args.load_camera)
    metrics = render_dataset(model, dataset, os.path.join(args.destination, "renders"),
                             save_images=not args.no_save_images)
    if metrics:
        summary = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
        summary["n_images"] = len(metrics)
        summary["n_points"] = model.num_points
        print(json.dumps(summary))
        with open(os.path.join(args.destination, "metrics.json"), "w") as f:
            json.dump({"per_image": metrics, "summary": summary}, f)


if __name__ == "__main__":
    main()
