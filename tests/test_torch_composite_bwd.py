"""PyTorch port vs JAX package: the backward tile compositor.

The port's ``CompositeSorted`` backward (on the CPU: ``composite_bwd_plain``,
then the per-Gaussian ``index_add_``) is held against ``jax.vjp`` of the JAX
package's ``composite_sorted`` with its Pallas kernels in interpret mode, on
the same per-Gaussian fields and sorted entries, with random cotangents on
all four colour channels and on final_T. Bars are the JAX package's own for
its kernel gradients (tests/test_pallas_kernel.py): rtol 2e-3 / atol 3e-5,
and 3e-3 / 5e-5 with the latch engaged."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops.rasterize import common as tcommon  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import composite as tcomp  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import tiled as ttiled  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import pallas_kernel as pk  # noqa: E402

from .test_torch_composite import _scene  # noqa: E402
from .test_torch_fixtures import activated_np, torch_args, torch_settings  # noqa: E402

BARS = {"normal": (2e-3, 3e-5), "opaque": (3e-3, 5e-5), "partly_empty": (2e-3, 3e-5)}


def _fields_and_entries(params, cam):
    settings = torch_settings(cam)
    tiles_x, tiles_y = tcommon.tile_grid(settings)
    pre = tcommon.preprocess(*torch_args(activated_np(params)), settings)
    ent = ttiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                              tiles_x, tiles_y)
    return tcomp.pack_fields(pre).detach(), ent, tiles_x


def _jax_vjp(fields10, ent, tiles_x, g_color4, g_t):
    """jax.vjp of composite_sorted on the port's sorted entries, padded to
    the kernel's chunk; returns the per-Gaussian gradients [10, N]."""
    n = fields10.shape[1]
    s_gidx = ent["s_gidx"].numpy()
    k = s_gidx.shape[0]
    kpad = max(pk.CHUNK, -(-k // pk.CHUNK) * pk.CHUNK)
    counts = np.bincount(s_gidx, minlength=n)
    offsets = np.cumsum(counts) - counts
    # A Gaussian's entries are emitted in tile order, which is their sorted
    # order too, so the emission order is the stable sort by Gaussian id.
    inv_pos = np.concatenate([np.argsort(s_gidx, kind="stable"), np.arange(k, kpad)])
    gidx_pad = np.concatenate([s_gidx, np.full(kpad - k, n)])   # clipped to N-1
    s_tile = np.concatenate([ent["s_tile"].numpy(), np.full(kpad - k, -1)])
    num_tiles = ent["range_start"].shape[0]

    def f(f10):
        return pk.composite_sorted(
            f10, jnp.asarray(gidx_pad, jnp.int32), jnp.asarray(inv_pos, jnp.int32),
            jnp.asarray(offsets, jnp.int32), jnp.asarray(counts, jnp.int32),
            jnp.asarray(s_tile, jnp.int32), jnp.asarray(ent["range_start"].numpy()),
            jnp.asarray(ent["range_end"].numpy()), jnp.int32(0), tiles_x, num_tiles, True)

    (color4, final_t), vjp = jax.vjp(f, jnp.asarray(fields10.numpy()))
    grad, = vjp((jnp.asarray(g_color4), jnp.asarray(g_t)))
    return np.asarray(color4), np.asarray(final_t), np.asarray(grad)


@pytest.mark.parametrize("case", ["normal", "opaque", "partly_empty"])
def test_composite_sorted_backward_matches_jax_vjp(case):
    fields10, ent, tiles_x = _fields_and_entries(*_scene(case))
    num_tiles = ent["range_start"].shape[0]
    rng = np.random.default_rng({"normal": 51, "opaque": 52, "partly_empty": 53}[case])
    g_color4 = rng.normal(0.0, 1.0, (num_tiles, 256, 4)).astype(np.float32)
    g_t = rng.normal(0.0, 1.0, (num_tiles, 256, 1)).astype(np.float32)

    f10 = fields10.clone().requires_grad_(True)
    color4, final_t = tcomp.CompositeSorted.apply(
        f10, ent["s_gidx"], ent["range_start"], ent["range_end"], tiles_x)
    torch.autograd.backward((color4, final_t),
                            (torch.from_numpy(g_color4), torch.from_numpy(g_t)))
    j_color4, j_final_t, j_grad = _jax_vjp(fields10, ent, tiles_x, g_color4, g_t)

    np.testing.assert_allclose(color4.detach().numpy()[..., :3], j_color4[..., :3], atol=1e-4)
    np.testing.assert_allclose(final_t.detach().numpy(), j_final_t, atol=1e-4)
    rtol, atol = BARS[case]
    assert np.abs(j_grad).max() > 1.0  # the cotangents reach the fields
    for row, name in enumerate(["x", "y", "A", "B", "C", "op", "r", "g", "b", "depth"]):
        np.testing.assert_allclose(f10.grad[row].numpy(), j_grad[row], rtol=rtol,
                                   atol=atol, err_msg=f"{case}: d{name}")
    if case == "opaque":
        e = fields10[:, ent["s_gidx"]].contiguous()
        latch = tcomp.composite_fwd(e, ent["range_start"], ent["range_end"], tiles_x)[2]
        assert (latch[..., 0] < ent["range_end"][:, None]).sum() > 100  # the latch is engaged
    if case == "partly_empty":
        nonempty = (ent["range_end"] > ent["range_start"]).numpy()
        assert 0 < nonempty.sum() < nonempty.size


def test_composite_bwd_with_no_entries_gives_zero_gradients():
    """K = 0 (every tile empty): zero gradients of the right shapes."""
    T = 6
    e = torch.zeros((10, 0))
    rs = re = torch.zeros(T, dtype=torch.int32)
    out = tcomp.composite_bwd(e, rs, re, 3, torch.ones((T, 256, 1)),
                              torch.zeros((T, 256, 1), dtype=torch.int32),
                              torch.ones((T, 256, 4)), torch.ones((T, 256, 1)))
    assert out.shape == (10, 0)
    f10 = torch.ones((10, 5), requires_grad=True)
    color4, final_t = tcomp.CompositeSorted.apply(f10, torch.zeros(0, dtype=torch.int64),
                                                  rs, re, 3)
    (color4.sum() + final_t.sum()).backward()
    assert f10.grad.shape == (10, 5) and (f10.grad == 0).all()


def test_plain_backward_matches_finite_differences():
    """A hand-made tile of three wide entries, in float64: the plain backward
    against central differences of the plain forward. The conics are wide enough
    that every pixel passes the alpha gate, the opacities keep alpha below
    the clamp and T far above the latch, so the function is smooth."""
    e = torch.tensor([
        [7.2, 8.5, 6.7],      # x
        [7.1, 6.2, 8.4],      # y
        [0.010, 0.008, 0.012],   # A
        [0.002, -0.001, 0.001],  # B
        [0.009, 0.011, 0.008],   # C
        [0.6, 0.5, 0.7],      # opacity
        [0.9, 0.2, 0.4], [0.1, 0.8, 0.3], [0.3, 0.4, 0.9],
        [2.0, 3.0, 4.0]], dtype=torch.float64)
    rs = torch.tensor([0], dtype=torch.int32)
    re = torch.tensor([3], dtype=torch.int32)
    rng = np.random.default_rng(54)
    gc = torch.from_numpy(rng.normal(size=(1, 256, 4)))
    gt = torch.from_numpy(rng.normal(size=(1, 256, 1)))

    def objective(ev):
        c4, ft, _ = tcomp.composite_fwd_plain(ev, rs, re, 1)
        return float((c4 * gc).sum() + (ft * gt).sum())

    latch = torch.full((1, 256, 1), 3, dtype=torch.int32)
    g = tcomp.composite_bwd_plain(e, rs, re, 1, None, latch, gc, gt)
    h = 1e-6
    for f in range(10):
        for k in range(3):
            ep, em = e.clone(), e.clone()
            ep[f, k] += h
            em[f, k] -= h
            fd = (objective(ep) - objective(em)) / (2 * h)
            assert abs(float(g[f, k]) - fd) <= 1e-6 * max(1.0, abs(fd)), (f, k, float(g[f, k]), fd)
