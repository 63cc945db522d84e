"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each reduced to one number held to its limit.

Training (``training_numbers``): the gap of each step's loss, relative to
the reference's; and, by the worst leaf (a parameter tensor, the
densification sums, the camera poses), the gap between the program's norm
and the reference's norm of the first step's gradient, of the last compared
step's gradient and of the change over the compared steps, measured against
the larger of the reference's norm of that leaf and of the median leaf. A
leaf whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone under Adam and is left out (of the first gradient
and the change by the first step's gradient, of the last gradient by its
own).

Rendering (``frame_numbers``): the mean and the largest gap, in 8-bit
levels, between the program's frames and the reference's.
"""
from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

SKIP_SHARE = 1e-3


@contextlib.contextmanager
def full_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(t).double()))


def worst_leaf_gap(program: dict, reference: dict, leaves) -> tuple:
    """(gap, leaf): the largest |‖program‖ − ‖reference‖| over ``leaves``,
    each divided by max(‖reference leaf‖, median leaf norm)."""
    ref = {k: _norm(reference[k]) for k in leaves}
    med = statistics.median(ref.values())
    gaps = {k: abs(_norm(program[k]) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moving_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient is at least ``SKIP_SHARE`` of the
    median leaf's."""
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= SKIP_SHARE * med]


def training_numbers(program: dict, reference: dict) -> dict:
    """Both dicts hold ``losses`` [k], ``grads`` and ``last_grads`` (the
    first and the k-th step's, by parameter), ``change`` (by leaf, over the
    k steps). Returns each number compared and the leaves it was worst on."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(program["losses"], reference["losses"])]
    kept = moving_leaves(reference["grads"])
    grad_gap, grad_leaf = worst_leaf_gap(program["grads"], reference["grads"], kept)
    last_grad_gap, last_grad_leaf = worst_leaf_gap(
        program["last_grads"], reference["last_grads"], moving_leaves(reference["last_grads"]))
    change_leaves = [k for k in reference["change"] if k in kept or k not in reference["grads"]]
    change_gap, change_leaf = worst_leaf_gap(program["change"], reference["change"],
                                             change_leaves)
    return {"loss_gap": max(losses), "grad_gap": grad_gap, "last_grad_gap": last_grad_gap,
            "change_gap": change_gap, "loss_gaps": losses,
            "grad_leaf": grad_leaf, "last_grad_leaf": last_grad_leaf, "change_leaf": change_leaf,
            "skipped": sorted(set(reference["grads"]) - set(kept))}


def frame_numbers(program_frames, reference_frames) -> dict:
    """Mean and largest |difference| in 8-bit levels over all pixels and
    channels of the frames compared."""
    diffs = [np.abs(p.astype(np.int16) - r.astype(np.int16))
             for p, r in zip(program_frames, reference_frames)]
    return {"frame_gap": float(np.mean([d.mean() for d in diffs])),
            "frame_gap_max": float(max(d.max() for d in diffs))}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number at or under its limit; a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
