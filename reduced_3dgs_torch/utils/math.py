"""Loss and metric helpers (counterpart of reduced_3dgs_tpu/utils/math.py)."""
from __future__ import annotations

import torch


def abs_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|, written as a select so that the subgradient at a == b is +1
    for ``a``, as JAX's ``abs`` gives it (``torch.abs`` gives 0)."""
    d = a - b
    return torch.where(d >= 0, d, -d)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean |a - b| (``abs_diff``)."""
    return torch.mean(abs_diff(a, b))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-channel PSNR of two [C, H, W] images, shape [C, 1]."""
    c = img1.shape[0]
    m = torch.mean((img1.reshape(c, -1) - img2.reshape(c, -1)) ** 2,
                   dim=1, keepdim=True)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(m, min=1e-12)))
