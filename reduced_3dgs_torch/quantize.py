"""Offline post-hoc quantization CLI (counterpart of reduced_3dgs_tpu/quantize.py:17-70).

Usage: python -m reduced_3dgs_torch.quantize -s <model_dir> -d <out_dir> -i <iteration>
           [-o key=value ...] [--device cuda]

Loads ``point_cloud.ply`` of the trained model, clusters it (cold: no
codebook yet) and writes ``point_cloud_quantized.ply``, then reads that file
back into a fresh model and writes it, dequantized, as ``point_cloud.ply``
beside it, with ``cfg_args`` and ``cameras.json`` copied over. ``-o`` sets
the quantizer's keywords (``num_clusters=256``, ``max_iter``, ...), each a
Python literal. Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import os
import shutil

from .quantization import ExcludeZeroSHQuantizer
from .shculling import VariableSHGaussianModel
from .train import parse_options
from .utils.device import resolve_device


def quantize_ply(sh_degree: int, load_ply: str, save_quantized: str,
                 save_dequantized: str = None, device="cuda", **quantizer_configs):
    """Quantize the PLY at ``load_ply`` into ``save_quantized`` and, when
    ``save_dequantized`` is given, write the model read back from that file
    there. Returns the loaded model."""
    device = resolve_device(device)
    gaussians = VariableSHGaussianModel(sh_degree, device=device).load_ply(load_ply)
    ExcludeZeroSHQuantizer(**quantizer_configs).save_quantized(gaussians, save_quantized)
    if save_dequantized:
        model2 = VariableSHGaussianModel(sh_degree, device=device)
        ExcludeZeroSHQuantizer(**quantizer_configs).load_quantized(model2, save_quantized)
        model2.save_ply(save_dequantized)
    return gaussians


def main(argv=None):
    from argparse import ArgumentParser
    parser = ArgumentParser()
    parser.add_argument("--sh_degree", default=3, type=int)
    parser.add_argument("-s", "--source", required=True, type=str)
    parser.add_argument("-d", "--destination", required=True, type=str)
    parser.add_argument("-i", "--iteration", default=30000, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("-o", "--option", default=[], action="append", type=str)
    args = parser.parse_args(argv)
    configs = parse_options(args.option)
    device = resolve_device(args.device)

    it_dir = os.path.join(args.source, "point_cloud", f"iteration_{args.iteration}")
    out_dir = os.path.join(args.destination, "point_cloud", f"iteration_{args.iteration}")
    os.makedirs(out_dir, exist_ok=True)
    quantize_ply(args.sh_degree, load_ply=os.path.join(it_dir, "point_cloud.ply"),
                 save_quantized=os.path.join(out_dir, "point_cloud_quantized.ply"),
                 save_dequantized=os.path.join(out_dir, "point_cloud.ply"), device=device,
                 **configs)
    for aux in ("cfg_args", "cameras.json"):
        src = os.path.join(args.source, aux)
        if os.path.exists(src) and args.source != args.destination:
            shutil.copy(src, os.path.join(args.destination, aux))


if __name__ == "__main__":
    main()
