"""The statistics compositor's CUDA kernel against chip_smoke's bar, and
copies of the kernel with one deliberate fault each against the same bar.

On the card the kernel as written must pass ``chip_smoke.compare_stats``
on the 200k-Gaussian bench scene at 544x976, on its opaque variant, and on
the bench scene at 540x970, where the right and bottom tiles reach past the
image (their outer pixels count, as in the JAX package); each faulty copy
must fail it on at least one of them. Run there from the repository root
with

    python -m pytest --noconftest -m cuda -s tests/test_torch_composite_stats_card.py

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
    # The transmittance after the entry instead of the incoming one.
    "t_after_entry": ("contrib ? T_in : 0.0f", "contrib ? p.T : 0.0f"),
    # The latching entry itself counts.
    "latch_inclusive": ("contrib = b == kContrib;", "contrib = b != kSkip;"),
    # count x alpha (its T_in-weighted mean, sum w / sum T_in) instead of
    # count x opacity.
    "alpha_for_opacity": ("cnt * batch[3 * tid + 1].y", "(ts > 0.0f ? cnt * ws / ts : 0.0f)"),
    # Entries past the block-wide exit keep whatever the buffer held.
    "unvisited_unwritten": ("stats[static_cast<size_t>(s) * K + idx] = 0.0f;",
                            "(void)s;"),
    # Pixels outside the (ragged scene's) image do not count.
    "out_of_image_dropped": ("contrib = b == kContrib;",
                             f"contrib = b == kContrib && px < {RAGGED_W}.0f "
                             f"&& py < {RAGGED_H}.0f;"),
    # The combine leaves out warp 0's slots.
    "warp_left_out": ("for (int w = 0; w < kWarps; ++w) {", "for (int w = 1; w < kWarps; ++w) {"),
    # An entry the warp's cull drops keeps whatever its slot held.
    "dropped_slot_unwritten": ("if (jl < n && !hit) slots.clear(warp, jl);", "(void)hit;"),
    # The entries after a warp's stop keep whatever their slots held.
    "stop_tail_unwritten": ("for (int j = j0 + lane; j < n; j += 32) slots.clear(warp, j);",
                            "(void)j0;"),
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
def cases(card):
    """chip_smoke's forward-compositor cases: the bench scene at camera 0,
    its opaque variant, and the bench scene at RAGGED_H x RAGGED_W."""
    import chip_smoke as cs
    from reduced_3dgs_torch.dataset.camera import build_camera, focal2fov
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    params = cs.bench_scene(0)

    def model(p):
        return VariableSHGaussianModel(3, device=card).load_numpy(p)

    cam = cs.view_camera(cs.view_poses()[0], card)
    ragged = build_camera(RAGGED_H, RAGGED_W, focal2fov(cs.FOCAL_X, RAGGED_W),
                          focal2fov(cs.FOCAL_Y, RAGGED_H), R=cam.R, T=cam.T, device=card)
    with torch.no_grad():
        return [cs.compare_compositor("bench", model(params), cam),
                cs.compare_compositor(
                    "opaque", model(dict(params, opacity=np.full_like(params["opacity"], 8.0))),
                    cam),
                cs.compare_compositor("ragged", model(params), ragged)]


def _fill_free_memory_with_nan(card):
    """Leave NaN in the memory the caching allocator hands out next, so that
    an output the kernel does not write shows."""
    free = torch.cuda.mem_get_info(card)[0]
    block = torch.full((int(free * 0.5) // 4,), math.nan, device=card)
    del block


@pytest.mark.cuda
def test_kernel_passes_the_bar(card, cases):
    import chip_smoke as cs
    with torch.no_grad():
        for case, name in zip(cases, ("bench", "opaque", "ragged")):
            _fill_free_memory_with_nan(card)
            cs.compare_stats(name, case)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_kernel_fails_the_bar(fault, card, cases, faulty_libraries, monkeypatch):
    import chip_smoke as cs
    # Only the compositor's library is the faulty copy (the preprocess has its own).
    real = _build.load_library
    monkeypatch.setattr(_build, "load_library", lambda name: (
        faulty_libraries[fault] if name == "composite_fwd" else real(name)))
    failed = []
    with torch.no_grad():
        for case, name in zip(cases, ("bench", "opaque", "ragged")):
            _fill_free_memory_with_nan(card)
            try:
                cs.compare_stats(f"{fault}: {name}", case)
            except AssertionError:
                failed.append(name)
    assert failed, f"{fault} passed the bar on every scene"
