"""LPIPS perceptual distance, AlexNet features (counterpart of
reduced_3dgs_tpu/metrics/lpips.py).

The network is the reference's lpipsPyTorch AlexNet LPIPS: the ImageNet
scaling layer (``_SHIFT``, ``_SCALE``), the five convolutions of
torchvision's AlexNet.features with ReLU and a 3x3 stride-2 max pool after
the first two, unit-normalised activations, and a 1x1 linear head per layer
whose output is averaged over the image. Nothing is downloaded: the weights
load from a local ``.npz`` with the JAX package's keys ``conv{0..4}/w``,
``conv{0..4}/b`` and ``lin{0..4}/w``, at ``$R3DGS_LPIPS_WEIGHTS`` or else
``<repo>/weights/lpips_alex.npz``. ``lpips_available()`` says whether they
are there; ``lpips`` raises a RuntimeError naming the path when they are
not. ``load_lpips_params`` turns such a dict of arrays (the JAX package's
params) into the port's tensors.

The convolutions are PyTorch's (the JAX function runs XLA convolutions, no
Pallas kernel) with cuDNN's TF32 off, the counterpart of JAX's
``precision="highest"``. On an NVIDIA H100 80GB HBM3 (700 W), with seeded
random weights and a perturbed render against its image (LPIPS 0.2036), the
card's distance with TF32 off was 1.49e-8 from the CPU's, and with TF32
allowed 1.58e-5 (chip_smoke.py phase 12 (e)).
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet normalisation of the reference's ScalingLayer.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet features: (out_channels, kernel, stride, padding); max pool after
# layers 0 and 1.
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}


def default_weights_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.environ.get("R3DGS_LPIPS_WEIGHTS", os.path.join(root, "weights", "lpips_alex.npz"))


@functools.lru_cache(maxsize=4)
def _load_weights_np(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def lpips_available() -> bool:
    return _load_weights_np(default_weights_path()) is not None


def load_lpips_params(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """The weights as float32 tensors on ``device``, by the ``.npz`` keys."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def _alex_features(params, x):
    feats = []
    for i, (_, _, stride, pad) in enumerate(_ALEX):
        x = F.relu(F.conv2d(x, params[f"conv{i}/w"], params[f"conv{i}/b"], stride=stride,
                            padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips(img1: torch.Tensor, img2: torch.Tensor,
          params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """LPIPS distance (a 0-d tensor) between [C,H,W] images in [0, 1].

    ``params`` (from ``load_lpips_params``) defaults to the weights at
    ``default_weights_path()``; raises RuntimeError when there are none."""
    if params is None:
        path = default_weights_path()
        weights = _load_weights_np(path)
        if weights is None:
            raise RuntimeError(
                f"LPIPS weights not found at {path}: export the torchvision + lpips AlexNet "
                "weights there (keys conv{0..4}/w, conv{0..4}/b, lin{0..4}/w) or point "
                "R3DGS_LPIPS_WEIGHTS at them; they cannot be downloaded here.")
        params = load_lpips_params(weights, img1.device)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _distance(params, img1, img2)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32


def _distance(params, img1, img2):
    """The LPIPS sum, with the convolutions at whatever precision cuDNN is
    allowed at the time."""
    shift = torch.as_tensor(_SHIFT, device=img1.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img1.device).view(1, 3, 1, 1)

    def prep(img):
        return (img[None] * 2.0 - 1.0 - shift) / scale

    f1 = _alex_features(params, prep(img1))
    f2 = _alex_features(params, prep(img2))
    total = torch.zeros((), dtype=img1.dtype, device=img1.device)
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + torch.mean(torch.sum(d * params[f"lin{i}/w"].view(1, -1, 1, 1), dim=1))
    return total
