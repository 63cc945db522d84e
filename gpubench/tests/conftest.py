"""Tiny cells for the CPU tests: the cells' own files with the scene, the
image and the step counts cut down, run through ``gpubench.run.execute``
(which skips the look for a card)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "config": {"n_gaussians": 2000, "image_height": 32, "image_width": 48,
               "views": {"count": 5, "fovx_deg": 70.0, "radius": 5.2, "elevation": 0.25,
                         "elevation_wave": 0.2, "waves": 3}},
    "workload": {"warmup_steps": 2, "trace_steps": 2, "warmup_frames": 1,
                 "trace_frames": 2, "compare_frames": 2},
}
CELLS = ("truck-flagship.steady", "truck-camera.steady", "truck-flagship.render")
SEED = 2 ** 31 + 12345


def tiny_run(cell, trace=False, seed=SEED, seconds=0.5, device="cpu"):
    from gpubench import run
    torch.set_num_threads(4)
    return run.execute(cell, seed, seconds, trace, device, overrides=TINY)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
