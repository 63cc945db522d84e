"""PyTorch + CUDA port of reduced_3dgs_tpu.

The module layout mirrors the JAX package so that each function has an
obvious counterpart. The package imports torch, numpy and PIL only; the
hand-written CUDA kernels under ``ops/rasterize/csrc`` are built with nvcc
at first use (see ``ops/rasterize/_build.py``).
"""
