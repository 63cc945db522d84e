"""The yardstick of the rooflines and of the step's share of the peak:
published peaks of the card, and the operations and bytes a step or a frame
needs, counted from the reference's own binning and compositing of the
views that the traced window rendered (``work``), so that the count is the
same whatever implements the work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s
float32 outside the tensor cores and 3.35 TB/s of HBM.

Per (pixel, entry) pair, the forward compositor B1 evaluates offsets (2),
the quadratic form (9), the exponential (1) and the gate (1): 13 float32
operations for each pair it scans (a pixel's entries up to the one that
ends it). The backward compositor B3 evaluates the same 13 on those pairs
and about 27 more on each pair that contributes (T and w 3, colour dot 7,
alpha 4, power 2, the conic and position partials 11). These are the
counts the port's kernel records use (``chip_smoke.py:276-286``).

Bytes count each input once and each output once: B1 reads 10 floats per
entry and two range bounds per tile and writes colour, depth, T and the
end index per pixel (24 B); B3 reads the entries and writes their 10
gradients, and reads T, the end index and the 5 cotangents per pixel.

The step's other work, per Gaussian: preprocess (projection 30, 3D
covariance 66, 2D covariance 100, inverse and radius 20, tile box 30,
opacity 4, view direction 10: 260), SH at degree d (basis 1, 4, 16, 40
operations for d = 0..3, and 6 (d+1)^2 for the products), their backward
at twice the forward, and Adam at 12 operations per parameter (59 floats a
Gaussian at degree 3). Per pixel: L1 4 per channel both ways; SSIM's
separable 11-tap blur of 5 maps per channel, forward (5 x 44) and backward
(the same blur of 5 cotangent maps), and 40 element operations each way.
"""
from __future__ import annotations

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

OPS_SCANNED = 13
OPS_CONTRIBUTING = 27
B1_BYTES_ENTRY, B1_BYTES_TILE, B1_BYTES_PIXEL = 40, 8, 24
B3_BYTES_ENTRY, B3_BYTES_TILE, B3_BYTES_PIXEL = 80, 8, 28

PREPROCESS_OPS = 260
SH_BASIS_OPS = (1, 4, 16, 40)
ADAM_OPS = 12
PARAMS_PER_GAUSSIAN = 59
SSIM_PIXEL_OPS = 3 * 2 * (5 * 44 + 40)
L1_PIXEL_OPS = 3 * 4


def sh_ops(degree_counts) -> int:
    """Forward SH operations for ``degree_counts[d]`` Gaussians at degree d."""
    return sum(n * (SH_BASIS_OPS[d] + 6 * (d + 1) ** 2) for d, n in enumerate(degree_counts))


def b1(view_work: dict) -> tuple:
    """(operations, bytes) of one forward compositor launch over a view."""
    ops = view_work["scanned_pairs"] * OPS_SCANNED
    nbytes = (view_work["entries"] * B1_BYTES_ENTRY + view_work["tiles"] * B1_BYTES_TILE
              + view_work["tiles"] * 256 * B1_BYTES_PIXEL)
    return ops, nbytes


def b3(view_work: dict) -> tuple:
    """(operations, bytes) of one backward compositor launch over a view."""
    ops = (view_work["scanned_pairs"] * OPS_SCANNED
           + view_work["contributing_pairs"] * OPS_CONTRIBUTING)
    nbytes = (view_work["entries"] * B3_BYTES_ENTRY + view_work["tiles"] * B3_BYTES_TILE
              + view_work["tiles"] * 256 * B3_BYTES_PIXEL)
    return ops, nbytes


def train_step_ops(view_work: dict) -> int:
    """Operations of one training step over a view: preprocess and SH both
    ways, B1, B3, the loss both ways and Adam."""
    n = view_work["gaussians"]
    per_gaussian = 3 * (n * PREPROCESS_OPS + sh_ops(view_work["degree_counts"]))
    pixels = view_work["pixels"] * (SSIM_PIXEL_OPS + L1_PIXEL_OPS)
    adam = n * PARAMS_PER_GAUSSIAN * ADAM_OPS
    return per_gaussian + b1(view_work)[0] + b3(view_work)[0] + pixels + adam


def roofline_share(ops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take, over ``seconds``, in %."""
    return 100.0 * max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) / seconds


def render_frame_ops(view_work: dict) -> int:
    """Operations of one rendered frame: preprocess and SH forward, and B1."""
    n = view_work["gaussians"]
    return n * PREPROCESS_OPS + sh_ops(view_work["degree_counts"]) + b1(view_work)[0]
