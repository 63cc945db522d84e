"""SSIM with an 11-tap, sigma 1.5 Gaussian window (counterpart of
reduced_3dgs_tpu/ops/ssim.py:13-18, 92-105): C1 = 0.01^2, C2 = 0.03^2,
zero 'same' padding, mean over all pixels and channels. Differentiable;
value and gradient are computed in the inputs' dtype (no TF32)."""
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


def _conv_blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 'same' blur of [M, H, W] maps as two depthwise conv2d, with
    cuDNN's TF32 off: it keeps about three decimal digits and would move
    SSIM and its gradient in the fourth."""
    m = x.shape[0]
    n = taps.numel()
    pad = n // 2
    wy = taps.view(1, 1, n, 1).expand(m, 1, n, 1).contiguous()
    wx = taps.view(1, 1, 1, n).expand(m, 1, 1, n).contiguous()
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x[None], wy, padding=(pad, 0), groups=m)
        y = F.conv2d(y, wx, padding=(0, pad), groups=m)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return y[0]


class _Blur(torch.autograd.Function):
    """The blur with a backward of its own, so that the backward
    convolutions, which autograd would run after the forward's TF32 switch
    is restored, run in full float32 too. The window is symmetric and the
    padding zero, so the blur is self-adjoint: its backward is the same
    blur of the cotangent."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.save_for_backward(taps)
        return _conv_blur(x, taps)

    @staticmethod
    def backward(ctx, g):
        taps, = ctx.saved_tensors
        return _conv_blur(g.contiguous(), taps), None


# The window's taps by (size, sigma, device, dtype): made once, so that a
# training step copies nothing from the host (and a CUDA graph of it reads
# the same tensor).
_TAPS = {}


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [M, H, W] maps, 'same' zero padding."""
    key = (window_size, sigma, x.device, x.dtype)
    if key not in _TAPS:
        _TAPS[key] = torch.from_numpy(_gaussian_window_np(window_size, sigma)).to(x.device,
                                                                                  x.dtype)
    return _Blur.apply(x, _TAPS[key])


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
