"""The backward compositor's CUDA kernel against chip_smoke's bar, and
copies of the kernel with one deliberate fault each against the same bar.

On the card the kernel as written must pass ``chip_smoke.compare_backward``
on the 200k-Gaussian 544x976 bench scene (cotangents from a real loss and
random ones) and on the opaque scene, in its per-entry form (the identity
ids) against the plain version and in its per-Gaussian form against the
per-entry form summed by ``index_add_``; each faulty copy must fail it on at
least one of them. The per-Gaussian form is held to the per-entry form
summed by ``index_add_`` at 200k and 1.25M Gaussians, with the exact buffer
and with a static one that has a tail. A static key buffer of twice the
entries gives the exact buffer's gradients within the same bar, whatever
its tail holds, and the faulty copy that walks on into the tail fails it.
Run there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_composite_bwd_card.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need). Without a card those tests skip; the check that every fault
still applies to the kernel's source runs everywhere.
"""
import ctypes
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
    # Every pixel walks on past its latch and its tile's range, to the end of
    # the buffer: the entries of later tiles and a static buffer's tail are
    # summed into the Gaussians their ids name.
    "walk_to_buffer_end": ("const int lat = latch[pix];", "const int lat = K;"),
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


def _backward_inputs(card, n, static):
    """B3's inputs for the bench scene of n Gaussians at camera 0, binned
    into the exact buffer or into the trainer's first static one (which then
    has a tail), with random cotangents: (e, s_gidx, range_start, range_end,
    tiles_x, final_t, latch, g_color4, g_t)."""
    import chip_smoke as cs
    from reduced_3dgs_torch.ops.rasterize import common, composite, tiled
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer.base import KEY_BUFFER_FACTOR

    model = VariableSHGaussianModel(3, device=card).load_numpy(cs.bench_scene(0, n))
    s = model.render_settings(cs.view_camera(cs.view_poses()[0], card))
    tx, ty = common.tile_grid(s)
    with torch.no_grad():
        pre = common.preprocess(*model.render_array_args(), s)
    K = None
    if static:
        cap = tiled.bucket_capacity(n)       # the trainer's first buffer (key_buffer_for)
        K = min(max(tiled.default_key_buffer_size(cap, tx, ty), KEY_BUFFER_FACTOR * cap),
                tiled.max_key_buffer(cap, tx, ty))
    ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths, tx, ty,
                             key_buffer_size=K)
    e = composite.gather_entries(composite.pack_fields(pre), ent["s_gidx"])
    rs, re = ent["range_start"], ent["range_end"]
    _, final_t, latch = composite.composite_fwd(e, rs, re, tx)
    gen = torch.Generator(device=card).manual_seed(n)
    g_color4 = torch.randn((rs.numel(), 256, 4), device=card, generator=gen)
    g_t = torch.randn((rs.numel(), 256, 1), device=card, generator=gen)
    return e, ent["s_gidx"], rs, re, tx, final_t, latch, g_color4, g_t


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200_000, 1_250_000])
@pytest.mark.parametrize("static", [False, True], ids=["exact", "static"])
def test_per_gaussian_form_matches_per_entry_sum(card, n, static):
    """The kernel given the entries' Gaussian ids gives, per Gaussian and per
    field, the per-entry form summed by index_add_ within chip_smoke's
    backward bar (TOL_BWD_REL of the field's largest value)."""
    import chip_smoke as cs
    from reduced_3dgs_torch.ops.rasterize import composite
    e, s_gidx, rs, re, tx, *rest = _backward_inputs(card, n, static)
    if static:
        assert int(re[-1]) < e.shape[1], "the static buffer has no tail"
    before = composite.composite_bwd.launches
    with torch.no_grad():
        fused = composite.composite_bwd_per_gaussian(e, s_gidx, n, rs, re, tx, *rest)
        per_entry = composite.sum_per_gaussian(composite.composite_bwd(e, rs, re, tx, *rest),
                                               s_gidx, n)
    torch.cuda.synchronize()
    assert composite.composite_bwd.launches == before + 2
    assert fused.shape == per_entry.shape == (composite.N_FIELDS, n)
    assert bool(torch.isfinite(fused).all())
    for f in range(composite.N_FIELDS):
        scale = float(per_entry[f].abs().max())
        assert scale > 0, f"field {f}: no gradient"
        assert float((fused[f] - per_entry[f]).abs().max()) <= cs.TOL_BWD_REL * scale, f


@pytest.mark.cuda
def test_per_entry_form_is_zero_past_every_latch(card):
    """The per-entry form (the identity ids onto zeros) is zero at each entry
    at or after every pixel of its tile's latch and in the static buffer's
    tail, and nonzero somewhere before."""
    from reduced_3dgs_torch.ops.rasterize import composite
    e, _, rs, re, tx, final_t, latch, g_color4, g_t = _backward_inputs(card, 200_000, True)
    with torch.no_grad():
        grads = composite.composite_bwd(e, rs, re, tx, final_t, latch, g_color4, g_t)
    stop = torch.maximum(latch[..., 0].amax(dim=1), rs).long()                 # [T]
    pos = torch.arange(e.shape[1], device=card)
    tile = torch.searchsorted(re.long(), pos, right=True)                      # T in the tail
    past = torch.ones_like(pos, dtype=torch.bool)
    inside = tile < rs.numel()
    past[inside] = pos[inside] >= stop[tile[inside]]
    assert bool(past[int(re[-1]):].all()) and bool((~past).any())
    assert bool((grads[:, past] == 0).all())
    assert bool((grads[:, ~past] != 0).any())


# The static key buffer's tail (tiled.bin_and_sort with key_buffer_size):
# B3 reads nothing past the last tile's range, and what the buffer holds
# there must reach no Gaussian. The tail is filled with copies of the
# entries in the tiles' ranges and of their ids before the kernel runs, so a
# kernel that read it would add gradient to real Gaussians.
def _copied_tail(per_gaussian):
    def composite_bwd_per_gaussian(e, s_gidx, n, range_start, range_end, *args, **kwargs):
        valid = int(range_end[-1])
        if valid < e.shape[1]:
            src = torch.arange(e.shape[1] - valid, device=e.device) % valid
            e = torch.cat([e[:, :valid], e[:, src]], 1)
            s_gidx = torch.cat([s_gidx[:valid], s_gidx[src]])
        return per_gaussian(e, s_gidx, n, range_start, range_end, *args, **kwargs)
    return composite_bwd_per_gaussian


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
    monkeypatch.setattr(composite, "composite_bwd_per_gaussian",
                        _copied_tail(composite.composite_bwd_per_gaussian))
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
def test_whole_buffer_sum_fails_the_bar(card, faulty_libraries, monkeypatch):
    """The faulty copy that walks on past the tiles' ranges sums the tail
    into real Gaussians: the static buffer's gradients leave the bar."""
    real = _build.load_library
    monkeypatch.setattr(_build, "load_library", lambda name: (
        faulty_libraries["walk_to_buffer_end"] if name == "composite_bwd" else real(name)))
    assert not _tail_within_bar(_tail_gradients(card, monkeypatch))
