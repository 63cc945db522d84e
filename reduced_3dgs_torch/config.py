"""Rasterizer constants (counterpart of reduced_3dgs_tpu/config.py:11-25).

16x16 pixel tiles and the alpha-compositing thresholds of the CUDA
rasterizer that both packages follow. The JAX package's strategy knobs
(R3DGS_SORT, R3DGS_EMISSION, R3DGS_ALIGN, ...) pick between TPU layouts and
have no counterpart here: the port always emits by gather, sorts by the
exact (tile, depth) key and leaves tile segments unaligned.
"""

BLOCK_X = 16
BLOCK_Y = 16
BLOCK_SIZE = BLOCK_X * BLOCK_Y

# Alpha-compositing thresholds.
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# Near-plane cull distance in view space.
NEAR_CULL_Z = 0.2

# EWA low-pass filter added to the 2D covariance diagonal.
COV2D_LOWPASS = 0.3
