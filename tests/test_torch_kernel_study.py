"""The CPU side of the kernels' build and measurement tools: the ptxas report
reader, the study's source copies, its warp layouts, and the warps' cull,
whose float arithmetic (tile_common.cuh's may_touch, mirrored by
kernel_study.may_touch) must never drop a pixel that the compositors' gate
would blend."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import _build, kernel_study  # noqa: E402

PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__c9fe58a0_19_v0_composite_fwd_cu_005dd90020composite_fwd_kernelILb1EEEvPKfiPKiS4_iP6float4PfPiS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__c9fe58a0_19_v0_composite_fwd_cu_005dd90020composite_fwd_kernelILb1EEEvPKfiPKiS4_iP6float4PfPiS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 24576 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN11tile_common17tile_order_kernelEPKiS1_iPi' for 'sm_90a'
ptxas info    : Function properties for _ZN11tile_common17tile_order_kernelEPKiS1_iPi
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, 380 bytes cmem[0]
"""


def test_parse_ptxas_reads_every_kernel():
    usage = _build.parse_ptxas(PTXAS_LOG)
    assert usage == {
        "composite_fwd_kernel<true>": dict(registers=32, smem_bytes=24576, spill_stores=0,
                                           spill_loads=0, stack_bytes=0),
        "tile_order_kernel": dict(registers=80, smem_bytes=0, spill_stores=4, spill_loads=8,
                                  stack_bytes=8)}


@pytest.mark.parametrize("mangled, name", [
    ("_ZN53_GLOBAL__N__e22be7b2_20_v10_composite_bwd_cu_b014129220composite_bwd_kernelEPKfiPKi",
     "composite_bwd_kernel"),
    ("_ZN52_GLOBAL__N__c9fe58a0_19_v0_composite_fwd_cu_005dd90020composite_fwd_kernelILb0EEEvPKf",
     "composite_fwd_kernel<false>"),
    ("_Z20composite_bwd_kernelPKfi", "composite_bwd_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_name_reads_the_mangled_name(mangled, name):
    assert _build._kernel_name(mangled) == name


def test_every_study_copy_of_this_tree_applies():
    """The copies meant for this tree's sources find their text there, each
    exactly once (a source edit that moves the text drops the copy)."""
    labels = {label for label, _, _ in kernel_study.variants(None)}
    for source, names in (("composite_fwd", ("fwd_fma_gate", "fwd_no_cull", "fwd_rows",
                                             "fwd_no_overlap", "fwd_occupancy8",
                                             "stats_no_shuffle", "stats_atomics", "timeline",
                                             "index_order")),
                          ("composite_bwd", ("bwd_no_shuffle", "bwd_group2", "bwd_group3",
                                             "bwd_no_cull", "bwd_rows", "bwd_batch64",
                                             "bwd_batch256", "bwd_no_overlap",
                                             "bwd_occupancy5", "bwd_one_reciprocal",
                                             "bwd_block_start", "timeline", "index_order"))):
        assert source in labels
        for name in names:
            assert f"{source}+{name}" in labels, name


def test_substitute_takes_the_first_alternative_that_applies():
    text = "a b c"
    assert kernel_study.substitute(text, ((("x", "y"),), (("b", "B"), ("c", "C")))) == "a B C"
    assert kernel_study.substitute(text, ((("x", "y"),),)) is None
    assert kernel_study.substitute("b b", ((("b", "B"),),)) is None


@pytest.mark.parametrize("width", [16, 8])
def test_warp_layout_covers_the_tile_once(width):
    pixel, boxes = kernel_study._layout(width)
    assert sorted(pixel.tolist()) == list(range(256))
    if width == 16:
        assert pixel.tolist() == list(range(256))
    for w, (bx, by, bw, bh) in enumerate(boxes):
        assert bw * bh == 32
        for p in pixel[32 * w:32 * (w + 1)].tolist():
            assert bx <= p % 16 < bx + bw and by <= p // 16 < by + bh


def _gate(e, px, py):
    """The compositors' gate in float32, each operation rounded on its own:
    power <= 0 and min(0.99, op exp(power)) >= 1/255."""
    x, y, A, B, C, op = e[:6]
    dx, dy = x - px, y - py
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    return (power <= 0.0) & (alpha >= 1.0 / 255.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_cull_keeps_every_pixel_the_gate_blends(seed):
    """Random screen-space Gaussians, round and very elongated, small and
    large, faint and opaque, around an 8 x 4 box of pixels: wherever the gate
    passes at a pixel of the box, the cull keeps the entry; and it drops a
    good share of the entries none of whose pixels pass."""
    rng = np.random.default_rng(seed)
    n = 20000
    x0, y0, w, h = 32.0, 48.0, 8, 4
    sx = np.exp(rng.uniform(np.log(0.3), np.log(40.0), n))
    sy = sx * np.exp(rng.uniform(np.log(1e-2), np.log(1.0), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cov = np.stack([c * c * sx ** 2 + s * s * sy ** 2 + 0.3, c * s * (sx ** 2 - sy ** 2),
                    s * s * sx ** 2 + c * c * sy ** 2 + 0.3], 0)
    det = cov[0] * cov[2] - cov[1] ** 2
    conic = np.stack([cov[2] / det, -cov[1] / det, cov[0] / det], 0)
    e = np.zeros((10, n), np.float32)
    e[0] = x0 + rng.uniform(-3 * sx, w + 3 * sx)
    e[1] = y0 + rng.uniform(-3 * sx, h + 3 * sx)
    e[2:5] = conic
    e[5] = np.exp(rng.uniform(np.log(1e-3), 0.0, n))
    e = torch.from_numpy(e)
    blended = torch.zeros(n, dtype=torch.bool)
    for py in range(int(y0), int(y0) + h):
        for px in range(int(x0), int(x0) + w):
            blended |= _gate(e, float(px), float(py))
    kept = kernel_study.may_touch(e, x0, x0 + w - 1, y0, y0 + h - 1)
    assert not bool((blended & ~kept).any())
    assert int(blended.sum()) > 1000
    assert int((~kept).sum()) > 0.3 * int((~blended).sum())
