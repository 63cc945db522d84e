from ..ops.ssim import ssim  # noqa: F401
from ..utils.math import psnr  # noqa: F401
from .lpips import load_lpips_params, lpips, lpips_available  # noqa: F401
