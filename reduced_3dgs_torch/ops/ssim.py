"""SSIM with an 11-tap, sigma 1.5 Gaussian window (counterpart of
reduced_3dgs_tpu/ops/ssim.py:13-18, 92-105): C1 = 0.01^2, C2 = 0.03^2,
zero 'same' padding, mean over all pixels and channels."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window_np(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [M, H, W] maps as two depthwise conv2d.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and would move SSIM in the fourth; the blur turns
    TF32 off for its two convolutions."""
    taps = torch.from_numpy(_gaussian_window_np(window_size, sigma)).to(x.device)
    m = x.shape[0]
    pad = window_size // 2
    wy = taps.view(1, 1, window_size, 1).expand(m, 1, window_size, 1).contiguous()
    wx = taps.view(1, 1, 1, window_size).expand(m, 1, 1, window_size).contiguous()
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x[None], wy, padding=(pad, 0), groups=m)
        y = F.conv2d(y, wx, padding=(0, pad), groups=m)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return y[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between two [C, H, W] images in [0, 1]."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    mu1, mu2, m11, m22, m12 = _blur(stacked, window_size, sigma).split(c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)
