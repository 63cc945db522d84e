"""The backward compositor's CUDA kernel against chip_smoke's bar, and
copies of the kernel with one deliberate fault each against the same bar.

On the card the kernel as written must pass ``chip_smoke.compare_backward``
on the 200k-Gaussian 544x976 bench scene (cotangents from a real loss and
random ones) and on the opaque scene, and each faulty copy must fail it on
at least one of them. A static key buffer of twice the entries gives the
exact buffer's gradients within the same bar, whatever its tail holds, and
a copy that sums the whole buffer per Gaussian fails it. Run there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_composite_bwd_card.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need). Without a card those tests skip; the check that every fault
still applies to the kernel's source runs everywhere.
"""
import ctypes
import functools
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import _build  # noqa: E402

# One fault each: (text of csrc/composite_bwd.cu, its replacement).
FAULTS = {
    # The carry starts at 0 instead of final_T g_T.
    "s_seed_zero": ("float S = T * g_t[pix];", "float S = 0.0f;"),
    # The latching entry itself contributes.
    "latch_inclusive": ("bool contrib = (lo + j < lat)", "bool contrib = (lo + j <= lat)"),
    # The conic cross term with a factor 1/2.
    "cross_term_half": ("vg[3] = dpower * (-dx * dy);", "vg[3] = dpower * (-0.5f * dx * dy);"),
    # The weight from the outgoing T instead of the incoming one.
    "weight_outgoing_t": ("const float w = alpha * T_in;", "const float w = alpha * T;"),
    # Gradient through the alpha clamp (only the opaque scene reaches it).
    "clamp_passes_gradient": ("raw < kAlphaMax ? dabar : 0.0f", "dabar"),
    # The last warp's share (the bottom-right 8 x 4 pixels of every tile)
    # left out of the tile's sums.
    "last_warp_dropped": ("if (store) atomicAdd(", "if (store && warp != kWarps - 1) atomicAdd("),
}


def _faulty_source(fault):
    with open(os.path.join(_build.CSRC_DIR, "composite_bwd.cu")) as f:
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
        src, lib = out / f"composite_bwd_{fault}.cu", out / f"libcomposite_bwd_{fault}.so"
        src.write_text(_faulty_source(fault))
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[fault] = (proc, lib)
    libs = {}
    for fault, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"nvcc failed for {fault}:\n{log}"
        cdll = ctypes.CDLL(str(lib))
        cdll.composite_bwd.argtypes = _build.ARGTYPES["composite_bwd"]
        cdll.composite_bwd.restype = ctypes.c_int
        libs[fault] = cdll
    return libs


@pytest.fixture(scope="module")
def cases(card):
    """chip_smoke's comparisons: (name, case, g_color4, g_t) for the bench
    scene with loss and random cotangents and the opaque scene with random
    ones, on the forward kernel's own buffers."""
    import chip_smoke as cs
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    params = cs.bench_scene(0)

    def model(p):
        return VariableSHGaussianModel(3, device=card).load_numpy(p)

    pose = cs.view_poses()[0]
    cam = cs.view_camera(pose, card)
    loss_cam = cs.view_camera(pose, card, bg_color=cs.LOSS_BG)
    gen = torch.Generator(device=card).manual_seed(11)

    def random_cotangents(case):
        t = case["inputs"][1].numel()
        return (torch.randn((t, 256, 4), device=card, generator=gen),
                torch.randn((t, 256, 1), device=card, generator=gen))

    with torch.no_grad():
        gt = torch.clamp(model(params)(loss_cam)["render"], 0, 1)
        real = cs.loss_cotangents(model(cs.perturbed(params)), loss_cam, gt)
        bench = cs.compare_compositor("bench", model(params), cam)
        opaque = cs.compare_compositor(
            "opaque", model(dict(params, opacity=np.full_like(params["opacity"], 8.0))), cam)
        return [("bench, loss cotangents", real, real["g_color4"], real["g_t"]),
                ("bench, random cotangents", bench, *random_cotangents(bench)),
                ("opaque, random cotangents", opaque, *random_cotangents(opaque))]


@pytest.mark.cuda
def test_kernel_passes_the_bar(cases):
    import chip_smoke as cs
    with torch.no_grad():
        for name, case, g_color4, g_t in cases:
            cs.compare_backward(name, case, g_color4, g_t)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_kernel_fails_the_bar(fault, cases, faulty_libraries, monkeypatch):
    import chip_smoke as cs
    # Only the compositor's library is the faulty copy (the preprocess has its own).
    real = _build.load_library
    monkeypatch.setattr(_build, "load_library", lambda name: (
        faulty_libraries[fault] if name == "composite_bwd" else real(name)))
    failed = []
    with torch.no_grad():
        for name, case, g_color4, g_t in cases:
            try:
                cs.compare_backward(f"{fault}: {name}", case, g_color4, g_t)
            except AssertionError:
                failed.append(name)
    assert failed, f"{fault} passed the bar on every scene"


# The static key buffer's tail (tiled.bin_and_sort with key_buffer_size):
# B3 writes no gradient past the last tile's range, and what the buffer
# holds there must reach no Gaussian. The tail is filled with NaN after the
# kernel runs, as memory it never wrote may hold anything.
def _nan_tail(kernel):
    @functools.wraps(kernel)  # keeps the launch counter the kernel's wrapper adds to
    def composite_bwd(e, range_start, range_end, *args, **kwargs):
        grads = kernel(e, range_start, range_end, *args, **kwargs)
        grads[:, int(range_end[-1]):] = float("nan")
        return grads
    return composite_bwd


def _sum_whole_buffer(per_entry, s_gidx, n):
    """The fault: one index_add_ over the whole buffer, the tail's ids taken
    as the last Gaussian's (where the binner's running maximum leaves them)."""
    return torch.zeros((per_entry.shape[0], n), dtype=per_entry.dtype,
                       device=per_entry.device).index_add_(1, torch.clamp(s_gidx, max=n - 1),
                                                           per_entry)


def _tail_gradients(card, monkeypatch):
    """The loss gradient of every parameter of the perturbed bench model at
    camera 0 with the key buffer at its entry count and at twice it."""
    import chip_smoke as cs
    from reduced_3dgs_torch.ops.rasterize import composite
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    params = cs.bench_scene(0)
    cam = cs.view_camera(cs.view_poses()[0], card, bg_color=cs.LOSS_BG)
    with torch.no_grad():
        gt = torch.clamp(VariableSHGaussianModel(3, device=card).load_numpy(params)(cam)["render"],
                         0, 1)
    monkeypatch.setattr(composite, "composite_bwd", _nan_tail(composite.composite_bwd))
    grads, total = {}, None
    for factor in (1, 2):
        model = VariableSHGaussianModel(3, device=card).load_numpy(cs.perturbed(params))
        if total is None:
            with torch.no_grad():
                total = model(cam)["num_rendered"]
        out = model.render(cam, key_buffer_size=factor * total)
        torch.mean((out["render"] - gt) ** 2).backward()
        grads[factor] = {k: p.grad for k, p in model.param_dict().items()}
    return grads


def _tail_within_bar(grads):
    """Every parameter's gradient with the tail within chip_smoke's backward
    bar (TOL_BWD_REL of its largest value) of the exact buffer's."""
    import chip_smoke as cs
    return all(bool(torch.isfinite(grads[2][k]).all())
               and float((grads[2][k] - g).abs().max()) <= cs.TOL_BWD_REL * float(g.abs().max())
               for k, g in grads[1].items())


@pytest.mark.cuda
def test_buffer_tail_reaches_no_gaussian(card, monkeypatch):
    assert _tail_within_bar(_tail_gradients(card, monkeypatch))


@pytest.mark.cuda
def test_whole_buffer_sum_fails_the_bar(card, monkeypatch):
    from reduced_3dgs_torch.ops.rasterize import composite
    monkeypatch.setattr(composite, "sum_per_gaussian", _sum_whole_buffer)
    assert not _tail_within_bar(_tail_gradients(card, monkeypatch))
