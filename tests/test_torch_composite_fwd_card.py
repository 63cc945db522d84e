"""The forward compositor's CUDA kernel against chip_smoke's bars, and copies
of the kernel with one deliberate fault each against the same bars.

On the card the kernel as written must pass ``chip_smoke.compare_compositor``
on the 200k-Gaussian bench scene at 544x976, on its opaque variant, and on
the bench scene at 540x970, where the right and bottom tiles reach past the
image; each faulty copy must fail it on at least one of them. Run there from
the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_composite_fwd_card.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need). Without a card those tests skip; the check that every fault
still applies to the kernel's source runs everywhere.
"""
import ctypes
import math
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import _build  # noqa: E402

# The ragged scene's size: not a multiple of 16 either way.
RAGGED_H, RAGGED_W = 540, 970
# One fault each: (text of csrc/composite_fwd.cu, its replacement).
FAULTS = {
    # The latch tested on the incoming T: the latching entry blends.
    "latch_inclusive": ("if (test_t < kTEps) return kLatch;", "if (T < kTEps) return kLatch;"),
    # The blend weight from the outgoing T instead of the incoming one.
    "weight_outgoing_t": ("w = alpha * T;", "w = alpha * test_t;"),
    # Entries with alpha < 1/255 blend instead of being skipped.
    "alpha_skip_dropped": ("if (alpha < kAlphaEps) return kSkip;",
                           "if (alpha < 0.0f) return kSkip;"),
    # Every field staged one slot too far: x lands where y belongs.
    "staging_offset": ("&stage[buf][tid * kStride + f]", "&stage[buf][tid * kStride + f + 1]"),
    # The next batch copied into the buffer the block is still walking.
    "next_batch_same_buffer": ("stage_batch(base + kPixels, buf ^ 1);",
                               "stage_batch(base + kPixels, buf);"),
}


def _faulty_source(fault):
    with open(os.path.join(_build.CSRC_DIR, "composite_fwd.cu")) as f:
        src = f.read()
    old, new = FAULTS[fault]
    assert src.count(old) == 1, f"{fault}: {old!r} is not in the source exactly once"
    return src.replace(old, new)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_applies_to_the_kernel_source(fault):
    """Each fault's text is in the kernel's source exactly once."""
    _faulty_source(fault)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def faulty_libraries(card, tmp_path_factory):
    """Each faulty copy of the kernel, built by nvcc (all at once) and loaded."""
    out = tmp_path_factory.mktemp("faulty_kernels")
    jobs = {}
    for fault in FAULTS:
        src, lib = out / f"composite_fwd_{fault}.cu", out / f"libcomposite_fwd_{fault}.so"
        src.write_text(_faulty_source(fault))
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[fault] = (proc, lib)
    libs = {}
    for fault, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"nvcc failed for {fault}:\n{log}"
        libs[fault] = _build.set_argtypes(ctypes.CDLL(str(lib)), "composite_fwd")
    return libs


@pytest.fixture(scope="module")
def scenes(card):
    """(name, model, camera): the bench scene at camera 0, its opaque variant,
    and the bench scene at RAGGED_H x RAGGED_W."""
    import chip_smoke as cs
    from reduced_3dgs_torch.dataset.camera import build_camera, focal2fov
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    params = cs.bench_scene(0)

    def model(p):
        return VariableSHGaussianModel(3, device=card).load_numpy(p)

    cam = cs.view_camera(cs.view_poses()[0], card)
    ragged = build_camera(RAGGED_H, RAGGED_W, focal2fov(cs.FOCAL_X, RAGGED_W),
                          focal2fov(cs.FOCAL_Y, RAGGED_H), R=cam.R, T=cam.T, device=card)
    return [("bench", model(params), cam),
            ("opaque", model(dict(params, opacity=np.full_like(params["opacity"], 8.0))), cam),
            ("ragged", model(params), ragged)]


def _fill_free_memory_with_nan(card):
    """Leave NaN in the memory the caching allocator hands out next, so that
    an output the kernel does not write shows."""
    free = torch.cuda.mem_get_info(card)[0]
    block = torch.full((int(free * 0.5) // 4,), math.nan, device=card)
    del block


@pytest.mark.cuda
def test_kernel_passes_the_bar(card, scenes):
    import chip_smoke as cs
    with torch.no_grad():
        for name, model, camera in scenes:
            _fill_free_memory_with_nan(card)
            cs.compare_compositor(name, model, camera)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_kernel_fails_the_bar(fault, card, scenes, faulty_libraries, monkeypatch):
    import chip_smoke as cs
    # Only the compositor's library is the faulty copy (the preprocess has its own).
    real = _build.load_library
    monkeypatch.setattr(_build, "load_library", lambda name: (
        faulty_libraries[fault] if name == "composite_fwd" else real(name)))
    failed = []
    with torch.no_grad():
        for name, model, camera in scenes:
            _fill_free_memory_with_nan(card)
            try:
                cs.compare_compositor(f"{fault}: {name}", model, camera)
            except AssertionError:
                failed.append(name)
    assert failed, f"{fault} passed the bar on every scene"
