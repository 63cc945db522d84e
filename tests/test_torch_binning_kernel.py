"""Binning and sort as CUDA kernels (``ops/rasterize/binning_kernel.py``,
``csrc/binning.cu``).

On the CPU: the kernels' algorithm, written out here step by step in
PyTorch (``_kernel_steps``: the counts and their scan in Gaussian order, the
stable depth sort of the Gaussians, the entries each keeps and their
emission in that order by the kernel's blocks, the stable sort on the tile
id's bits alone, the outputs and the tile ranges by the boundary rule), is
bit for bit ``tiled.bin_and_sort_plain`` on cases with exact depth ties,
Gaussians without entries, single-tile and full-image rects, bands, an exact
static buffer, a static buffer with a tail, buffers that cut inside one
Gaussian's entries, and no entries at all; the boundary rule is
``torch.searchsorted``'s answer with empty tiles at the start, in the middle
and at the end; the wrappers check their arguments and count their launches.
On the card (marker ``cuda``): the kernels against the plain version on CPU
copies at the bench scene and at 1.25M Gaussians at 979x546 with the truck
cell's key buffer, exact and static, with overflow, in a band and with
depth ties; a captured and replayed binning against an eager one, with no
host sync; a 2DGS render and an importance sweep against the same with the
plain binning on the card. Run there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_binning_kernel.py

(``--noconftest`` because the suite's conftest imports JAX, which this file
does not).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import binning_kernel as bk  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import launches, tiled  # noqa: E402
from reduced_3dgs_torch.ops.rasterize.composite import TAIL_SCRATCH  # noqa: E402
from reduced_3dgs_torch.utils import profiling  # noqa: E402

# Gaussians a block of emit_kernel takes (csrc/binning.cu's kBlock).
BLOCK = 256
# The truck cell's static key buffer.
TRUCK_K = 10_380_288


def _ranges(s_tile: torch.Tensor, num_tiles: int):
    """Step 5's boundary rule: at position i, the tiles in (s_tile[i-1],
    s_tile[i]] start at i and those in [s_tile[i-1], s_tile[i]) end at i,
    with s_tile[-1] = -1 and s_tile[K] = num_tiles."""
    st = s_tile.tolist()
    start = [None] * num_tiles
    end = [None] * num_tiles
    for i in range(len(st) + 1):
        prev = st[i - 1] if i > 0 else -1
        cur = st[i] if i < len(st) else num_tiles
        for t in range(max(prev + 1, 0), min(cur, num_tiles - 1) + 1):
            start[t] = i
        for t in range(max(prev, 0), min(cur, num_tiles)):
            end[t] = i
    return torch.tensor(start, dtype=torch.int32), torch.tensor(end, dtype=torch.int32)


def _kernel_steps(rect_min, rect_max, tiles_touched, depths, tiles_x, tiles_y,
                  tile_row_offset=0, key_buffer_size=None) -> dict:
    """The kernels' algorithm in PyTorch, step for step (see the source's
    note); returns ``bin_and_sort``'s dict."""
    n = rect_min.shape[0]
    num_tiles = tiles_x * tiles_y
    # 1. count_kernel, then the inclusive scan in Gaussian order.
    rect_w = (rect_max[:, 0] - rect_min[:, 0]).long()
    y0 = torch.clamp(rect_min[:, 1] - tile_row_offset, 0, tiles_y).long()
    y1 = torch.clamp(rect_max[:, 1] - tile_row_offset, 0, tiles_y).long()
    counts = torch.where(tiles_touched > 0, rect_w * torch.clamp(y1 - y0, min=0), 0)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    depth_bits = depths.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = torch.where(counts > 0, depth_bits, 0xFFFFFFFF)
    static = key_buffer_size is not None
    K = int(key_buffer_size) if static else int(offsets[n])
    # 2. the stable sort of the Gaussians by depth bits.
    order = torch.sort(keys, stable=True).indices
    # 3. the entries each keeps, in that order, and their emission.
    kept = torch.clamp(torch.minimum(counts[order], K - offsets[:-1][order]), min=0)
    ends = torch.cumsum(kept, 0)
    positions = torch.arange(K)
    tiles = torch.full((K,), num_tiles, dtype=torch.int64)      # the tail's
    ids = n + positions % TAIL_SCRATCH
    for j0 in range(0, n, BLOCK):
        block_ends = ends[j0:j0 + BLOCK]
        start = int(ends[j0 - 1]) if j0 > 0 else 0
        p = torch.arange(start, int(block_ends[-1]))
        lo = torch.searchsorted(block_ends, p, right=True)
        ordinal = p - torch.where(lo > 0, block_ends[(lo - 1).clamp(min=0)], start)
        g = order[j0 + lo]
        w = torch.clamp(rect_w[g], min=1)
        tiles[p] = (y0[g] + ordinal // w) * tiles_x + rect_min[g, 0].long() + ordinal % w
        ids[p] = g
    # 4. the stable sort on the tile id's low bits alone.
    perm = torch.sort(tiles & ((1 << bk.tile_bits(num_tiles)) - 1), stable=True).indices
    s_tile, s_ids = tiles[perm], ids[perm]
    # 5. finish_kernel.
    in_tile = s_tile < num_tiles
    range_start, range_end = _ranges(s_tile, num_tiles)
    out = dict(s_tile=s_tile, s_gidx=torch.where(in_tile, s_ids, n + positions % TAIL_SCRATCH),
               range_start=range_start, range_end=range_end)
    if static:
        out.update(valid=in_tile, overflow=offsets[n] > K, num_rendered=offsets[n])
    else:
        out["num_rendered"] = K
    return out


def _rects(rng, n, tiles_x, tiles_y, max_w=4):
    x0 = rng.integers(0, tiles_x + 1, n)
    y0 = rng.integers(0, tiles_y + 1, n)
    x1 = np.minimum(x0 + rng.integers(0, max_w + 1, n), tiles_x)
    y1 = np.minimum(y0 + rng.integers(0, max_w + 1, n), tiles_y)
    return np.stack([x0, y0], 1), np.stack([x1, y1], 1)


def _case(name, seed=31):
    """([rect_min, rect_max, tiles_touched, depths], tiles_x, tiles_y,
    tile_row_offset) of a case; the rects are in the image's tile rows (a
    band clips them)."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y, n, offset = 9, 6, 300, 0
    lo, hi = _rects(rng, n, tiles_x, tiles_y)
    depths = rng.uniform(0.3, 8.0, n)
    culled = rng.uniform(size=n) < 0.2
    if name == "ties":
        depths = rng.choice([0.5, 1.25, 2.0, 4.0], n)
    elif name == "zero_counts":
        culled = rng.uniform(size=n) < 0.6
        hi[::7, 0] = lo[::7, 0]                      # zero-width rects
    elif name == "single_and_full":
        hi[::2] = np.minimum(lo[::2] + 1, [tiles_x, tiles_y])
        lo[1::5], hi[1::5] = (0, 0), (tiles_x, tiles_y)
    elif name == "band":
        offset, image_rows = 2, tiles_y
        tiles_y = 3
        lo, hi = _rects(rng, n, tiles_x, image_rows)
    elif name == "no_entries":
        culled[:] = True
    tiles_touched = np.where(culled, 0, (hi - lo).clip(min=0).prod(1))
    if name == "zero_counts":
        tiles_touched[::7] = np.where(culled[::7], 0, 5)    # touched, yet no entry
    args = [torch.tensor(lo, dtype=torch.int32), torch.tensor(hi, dtype=torch.int32),
            torch.tensor(tiles_touched, dtype=torch.int32),
            torch.tensor(depths, dtype=torch.float32)]
    return args, tiles_x, tiles_y, offset


def _buffer(mode, args, tiles_x, tiles_y, offset):
    """The key buffer of ``mode`` for a case: None (exact), the total
    (exact static), the total and a tail, or a buffer that ends inside one
    Gaussian's entries (the first with 3 or more) or at 60% of the total."""
    if mode == "exact":
        return None
    total = tiled.bin_and_sort_plain(*args, tiles_x, tiles_y, offset)["num_rendered"]
    if mode == "static_exact":
        return total
    if mode == "static_tail":
        return total + 37
    if mode == "cut_inside":
        rect_min, rect_max, touched = args[:3]
        y0 = torch.clamp(rect_min[:, 1] - offset, 0, tiles_y)
        y1 = torch.clamp(rect_max[:, 1] - offset, 0, tiles_y)
        counts = torch.where(touched > 0, (rect_max[:, 0] - rect_min[:, 0]).long()
                             * (y1 - y0).clamp(min=0).long(), 0)
        g = int(torch.nonzero(counts >= 3)[0])
        return int(counts[:g].sum()) + 1
    return int(0.6 * total)


CASES = [("random", "exact"), ("random", "static_tail"), ("ties", "exact"),
         ("ties", "static_tail"), ("zero_counts", "exact"), ("zero_counts", "static_tail"),
         ("single_and_full", "exact"), ("single_and_full", "cut_inside"), ("band", "exact"),
         ("band", "static_tail"), ("band", "cut_inside"), ("random", "static_exact"),
         ("random", "cut_inside"), ("random", "sixty_percent"), ("ties", "sixty_percent"),
         ("no_entries", "exact"), ("no_entries", "static_tail")]


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, key
            assert g.shape == w.shape and torch.equal(g.cpu(), w.cpu()), key
        else:
            assert type(g) is type(w) and g == w, key


@pytest.mark.parametrize("case, mode", CASES)
def test_kernel_steps_equal_the_plain_version(case, mode):
    args, tiles_x, tiles_y, offset = _case(case)
    K = _buffer(mode, args, tiles_x, tiles_y, offset)
    want = tiled.bin_and_sort_plain(*args, tiles_x, tiles_y, offset, key_buffer_size=K)
    got = _kernel_steps(*args, tiles_x, tiles_y, offset, key_buffer_size=K)
    _assert_same(got, want)
    total = int(want["num_rendered"])
    if mode in ("cut_inside", "sixty_percent"):
        assert bool(want["overflow"]) and total > K
    if mode == "static_tail":
        assert not bool(want["overflow"]) and int(want["valid"].sum()) == total
    if case == "no_entries":
        assert total == 0
    elif case == "ties":
        # Ties on depth decide the order in most tiles.
        tie = (want["s_tile"][1:] == want["s_tile"][:-1]) & (
            args[3][want["s_gidx"][1:].clamp(max=299)] ==
            args[3][want["s_gidx"][:-1].clamp(max=299)])
        assert int(tie.sum()) > 50


@pytest.mark.parametrize("s_tile, num_tiles", [
    ([2, 2, 3, 3, 3, 6, 6, 9, 9], 9),             # empty tiles 0-1, 4-5 and 7-8
    ([0, 0, 1, 4, 4, 4], 6),                      # ends without a tail
    ([5, 5], 5),                                   # a tail alone
    ([], 4),                                       # no entries
    ([3], 4)])
def test_boundary_rule_is_searchsorted(s_tile, num_tiles):
    st = torch.tensor(s_tile, dtype=torch.int64)
    tiles = torch.arange(num_tiles)
    start, end = _ranges(st, num_tiles)
    assert torch.equal(start, torch.searchsorted(st, tiles).to(torch.int32))
    assert torch.equal(end, torch.searchsorted(st, tiles, right=True).to(torch.int32))


def test_boundary_rule_on_random_sorted_tiles():
    gen = torch.Generator().manual_seed(4)
    for _ in range(20):
        num_tiles = int(torch.randint(1, 40, (1,), generator=gen))
        st = torch.sort(torch.randint(0, num_tiles + 1, (int(torch.randint(0, 200, (1,),
                                                                           generator=gen)),),
                                      generator=gen)).values
        tiles = torch.arange(num_tiles)
        start, end = _ranges(st, num_tiles)
        assert torch.equal(start, torch.searchsorted(st, tiles).to(torch.int32))
        assert torch.equal(end, torch.searchsorted(st, tiles, right=True).to(torch.int32))


def test_tile_bits_hold_the_sentinel():
    for num_tiles in (1, 2, 3, 4, 255, 256, 2170, 4095, 4096):
        bits = bk.tile_bits(num_tiles)
        assert num_tiles < 2 ** bits and (bits == 1 or num_tiles >= 2 ** (bits - 1))


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "depths", "other_device"])
def test_wrapper_checks_its_arguments(case):
    args, tiles_x, tiles_y, offset = _case("random")
    if case == "device":
        match = "runs on cuda tensors"
    elif case == "dtype":
        args[0] = args[0].long()
        match = "rect_min must be torch.int32"
    elif case == "shape":
        args[1] = torch.zeros((args[1].shape[0], 3), dtype=torch.int32)
        match = "rect_max must be torch.int32"
    elif case == "depths":
        args[3] = args[3].double()
        match = "depths must be torch.float32"
    else:
        args[2] = args[2].to("meta")
        match = "tiles_touched is on meta"
    with pytest.raises(ValueError, match=match):
        bk.bin_count(*args, tiles_y, offset)
    with pytest.raises(ValueError, match=match):
        bk.bin_and_sort(*args, tiles_x, tiles_y, offset, 64)


@pytest.mark.parametrize("K", [-1, 2 ** 31])
def test_sort_wrapper_checks_the_buffer(K):
    args = _case("random")[0]
    counted_ = bk.Counts(args[0], args[1], torch.zeros(301, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.uint8), [0] * 7)
    with pytest.raises(ValueError, match="the key buffer takes"):
        bk.bin_sort(counted_, K, 9, 6)


def test_cuda_tensors_go_to_the_kernels(monkeypatch):
    class OnCard:
        device = torch.device("cuda")

    seen = []
    monkeypatch.setattr(bk, "bin_and_sort", lambda *a: seen.append(a) or "kernels")
    assert tiled.bin_and_sort(OnCard(), None, None, None, 3, 2, 0, 8) == "kernels"
    assert seen and seen[0][4:] == (3, 2, 0, 8)
    args, tiles_x, tiles_y, offset = _case("random")
    _assert_same(tiled.bin_and_sort(*args, tiles_x, tiles_y, offset),
                 tiled.bin_and_sort_plain(*args, tiles_x, tiles_y, offset))


def test_launch_counters_are_in_the_tallies():
    out = profiling.counters()
    assert {"binning_kernel.bin_count.launches", "binning_kernel.bin_sort.launches"} <= set(out)
    assert {"bin_count", "bin_sort"} <= set(launches.captured_launches)
    before = bk.bin_count.launches, bk.bin_sort.launches
    launches.add_replayed_launches({"bin_count": 3, "bin_sort": 3})
    assert (bk.bin_count.launches, bk.bin_sort.launches) == (before[0] + 3, before[1] + 3)
    bk.bin_count.launches, bk.bin_sort.launches = before


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_SCENES = {}


def _card_scene(which, device):
    """(preprocessed Gaussians, tiles_x, tiles_y) on the card: chip_smoke's
    bench scene at its view 0, or 1,250,000 random Gaussians at 979x546
    around a turned camera (kept for the module)."""
    if which in _SCENES:
        return _SCENES[which]
    from reduced_3dgs_torch.ops.rasterize import common
    if which == "bench":
        import chip_smoke as cs
        from reduced_3dgs_torch.shculling import VariableSHGaussianModel
        model = VariableSHGaussianModel(3, device=device).load_numpy(cs.bench_scene(0))
        s = model.render_settings(cs.view_camera(cs.view_poses()[0], device))
        arrays = [a.detach().contiguous() for a in model.render_array_args()]
    else:
        from .test_torch_fixtures import (activated_np, camera_np, random_cloud_np,
                                          rotation_y, torch_settings)
        params, _ = random_cloud_np(18, 1_250_000, spread=3.0, z_spread=3.5, scale_lo=-5.0,
                                    scale_hi=-2.0)
        cam = camera_np(546, 979, fovx=math.radians(70), R=rotation_y(0.2), T=(0.1, -0.1, 0.3))
        s = torch_settings(cam, sh_degree=3)
        s = s._replace(bg=s.bg.to(device), viewmatrix=s.viewmatrix.to(device),
                       projmatrix=s.projmatrix.to(device), campos=s.campos.to(device))
        arrays = [torch.tensor(a, device=device) for a in activated_np(params)]
    with torch.no_grad():
        pre = common.preprocess(*arrays, s)
    _SCENES[which] = (pre, *common.tile_grid(s))
    return _SCENES[which]


def _card_args(pre, mode):
    depths = pre.depths
    if mode == "ties":
        # Depths rounded to 1/64: thousands of exact ties in every tile.
        depths = torch.round(depths * 64) / 64
    return [pre.rect_min, pre.rect_max, pre.tiles_touched, depths]


@pytest.mark.cuda
@pytest.mark.parametrize("which, mode", [
    ("bench", "exact"), ("bench", "static"), ("bench", "overflow"), ("bench", "band"),
    ("bench", "band_static"), ("bench", "ties"), ("truck", "exact"), ("truck", "static"),
    ("truck", "overflow"), ("truck", "band_static")])
def test_card_kernels_against_plain(card, which, mode):
    pre, tiles_x, tiles_y = _card_scene(which, card)
    args = _card_args(pre, mode)
    offset, rows = (3, 10) if mode.startswith("band") else (0, tiles_y)
    total = int(tiled.bin_and_sort_plain(*(a.cpu() for a in args), tiles_x, rows,
                                         offset)["num_rendered"])
    K = {"exact": None, "ties": None, "band": None, "overflow": int(0.6 * total),
         "static": TRUCK_K if which == "truck" else 2 * total, "band_static": total + 1000}[mode]
    got = tiled.bin_and_sort(*args, tiles_x, rows, offset, key_buffer_size=K)
    torch.cuda.synchronize()
    want = tiled.bin_and_sort_plain(*(a.cpu() for a in args), tiles_x, rows, offset,
                                    key_buffer_size=K)
    _assert_same(got, want)
    assert total > 10 * tiles_x * rows
    if mode == "overflow":
        assert bool(got["overflow"])


@pytest.mark.cuda
def test_card_captured_binning_equals_eager_without_a_sync(card):
    pre, tiles_x, tiles_y = _card_scene("bench", card)
    args = _card_args(pre, "static")
    K = 2 * int(tiled.bin_and_sort(*args, tiles_x, tiles_y)["num_rendered"])

    def call():
        return tiled.bin_and_sort(*args, tiles_x, tiles_y, key_buffer_size=K)

    before = bk.bin_count.launches, bk.bin_sort.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (bk.bin_count.launches, bk.bin_sort.launches) == (before[0] + 1, before[1] + 1)
    captured = dict(launches.captured_launches)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    for name in ("bin_count", "bin_sort"):
        assert launches.captured_launches[name] == captured[name] + 1
    graph.replay()
    torch.cuda.synchronize()
    _assert_same(replayed, eager)


def _plain_on_card(monkeypatch, module, recorded):
    """Route ``module.bin_and_sort`` to the plain version on the card (the
    binning before the kernels), recording each result."""
    def plain(*args, **kwargs):
        out = tiled.bin_and_sort_plain(*args, **kwargs)
        recorded.append(out)
        return out
    monkeypatch.setattr(module, "bin_and_sort", plain)


def _recording(monkeypatch, module, recorded):
    kernels = module.bin_and_sort

    def record(*args, **kwargs):
        out = kernels(*args, **kwargs)
        recorded.append(out)
        return out
    monkeypatch.setattr(module, "bin_and_sort", record)


@pytest.mark.cuda
def test_card_twodgs_render_unchanged(card, monkeypatch):
    """A 2DGS render of the bench scene's 20,000 Gaussians of smallest x:
    the binning it reads bit for bit the plain version's on the card, its
    images within the surfel compositor's own run-to-run bar (its per-tile
    sums are index_add_'s float atomics; chip_smoke's TOL_TILE)."""
    import chip_smoke as cs
    from reduced_3dgs_torch.ops.rasterize import twodgs
    from reduced_3dgs_torch.shculling import VariableSHGsplat2DGSGaussianModel
    params = cs.bench_scene(0)
    keep = np.argsort(params["xyz"][:, 0])[:20_000]
    model = VariableSHGsplat2DGSGaussianModel(3, device=card).load_numpy(
        {k: v[keep] for k, v in params.items()})
    camera = cs.view_camera(cs.view_poses()[0], card)
    outs, bins = {}, {}
    for route in ("kernels", "plain"):
        bins[route] = []
        with monkeypatch.context() as m:
            (_recording if route == "kernels" else _plain_on_card)(m, twodgs, bins[route])
            with torch.no_grad():
                outs[route] = model.render(camera)
    torch.cuda.synchronize()
    assert len(bins["kernels"]) == len(bins["plain"]) == 1
    _assert_same(bins["kernels"][0], bins["plain"][0])
    for key in cs.TWODGS_OUTPUTS:
        a, b = outs["kernels"][key], outs["plain"][key]
        assert float((a - b).abs().max()) <= cs.TOL_TILE * float(b.abs().max()), key


@pytest.mark.cuda
def test_card_importance_sweep_unchanged(card, monkeypatch):
    """The importance sweep over four views of one FoV (a sweep graph with
    the static buffer): counts equal and scores within the statistics
    compositor's bar (chip_smoke's TOL_STATS_REL: its per-Gaussian sums are
    index_add_'s float atomics) with the plain binning on the card; the last
    view's binning bit for bit."""
    import chip_smoke as cs
    from reduced_3dgs_torch.dataset.camera import sweep_cameras
    from reduced_3dgs_torch.importance import trainer as imp
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    model = VariableSHGaussianModel(3, device=card).load_numpy(cs.bench_scene(0))
    cams = sweep_cameras([cs.view_camera(p, card) for p in cs.sweep_poses(cs.N_VIEWS)])
    results, bins = {}, {}
    for route in ("kernels", "plain"):
        bins[route] = []
        with monkeypatch.context() as m:
            (_recording if route == "kernels" else _plain_on_card)(m, tiled, bins[route])
            results[route] = imp.prune_list(model, cams)
    torch.cuda.synchronize()
    got, want = results["kernels"], results["plain"]
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= cs.TOL_STATS_REL * float(w.abs().max())
    assert bins["kernels"] and len(bins["kernels"]) == len(bins["plain"])
    _assert_same(bins["kernels"][-1], bins["plain"][-1])
