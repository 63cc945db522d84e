"""PyTorch port vs JAX package: the statistics compositor and the render
with statistics.

The port's plain statistics compositor (what ``composite_fwd_stats`` runs
on CPU tensors) and the JAX package's Pallas kernel ``tile_composite_fwd``
with ``with_stats=True`` in interpret mode read the same sorted entry
buffer; their per-entry statistics are compared entry by entry. The render
with statistics is compared per Gaussian with the JAX render on its XLA
path and on its Pallas path in interpret mode, at a size that is not a
multiple of 16, so that pixels outside the image count (the JAX package has
no in-image mask). Bars are the JAX package's own for its kernel
(tests/test_pallas_kernel.py:174-179): counts exact, scores rtol and atol
1e-4."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import config as tconfig  # noqa: E402
from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import composite as tcomp  # noqa: E402
from reduced_3dgs_tpu.dataset.camera import build_camera as jbuild_camera  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import pallas_kernel as pk  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize.tiled import render_tiled as jrender_tiled  # noqa: E402

from .test_torch_composite import _scene, _sorted_entries  # noqa: E402
from .test_torch_fixtures import jax_model, random_cloud_np, rotation_y, torch_model  # noqa: E402

STAT_KEYS = ("opacity_important_score", "T_alpha_important_score", "transmittance_sum")


def _jax_stats(e, range_start, range_end, tiles_x):
    num_tiles = range_start.shape[0]
    k = e.shape[1]
    kpad = max(pk.CHUNK, -(-k // pk.CHUNK) * pk.CHUNK)
    e_pad = np.zeros((tcomp.N_FIELDS, kpad), np.float32)
    e_pad[:, :k] = e.numpy()
    rs, re = jnp.asarray(range_start.numpy()), jnp.asarray(range_end.numpy())
    steps = pk.step_layout(rs, re, kpad, num_tiles)
    *_, stats = pk.tile_composite_fwd(jnp.asarray(e_pad), *steps, 0, tiles_x, num_tiles,
                                      interpret=True, with_stats=True)
    return np.asarray(stats)[:4, :k]


@pytest.mark.parametrize("case", ["normal", "opaque", "partly_empty"])
def test_plain_stats_compositor_matches_pallas_kernel(case):
    e, rs, re, tiles_x = _sorted_entries(*_scene(case))
    color4, final_t, latch, stats = tcomp.composite_fwd_stats(e, rs, re, tiles_x)
    # The statistics form composites exactly as the plain compositor does.
    for a, b in zip((color4, final_t, latch), tcomp.composite_fwd(e, rs, re, tiles_x)):
        assert torch.equal(a, b)
    assert stats.shape == (4, e.shape[1]) and stats.dtype == torch.float32
    j_stats = _jax_stats(e, rs, re, tiles_x)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[0], j_stats[0])            # counts exact
    np.testing.assert_allclose(stats[1:], j_stats[1:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stats[1], stats[0] * e[5].numpy(), rtol=1e-6)
    assert stats[0].max() > 10 and (stats[3] >= stats[2]).all()    # T_in >= alpha T_in
    if case == "opaque":
        # Latched pixels end their entries' counts: some entries (past
        # every latch of their tile) contribute nowhere, and get zeros.
        unreached = stats[0] == 0
        assert unreached.sum() > 10 and (stats[:, unreached] == 0).all()


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_render_with_stats_matches_jax(jax_path):
    h, w = 40, 56  # not multiples of 16: the ragged tiles' outer pixels count
    params, degrees = random_cloud_np(45, 90, spread=1.0)
    kw = dict(image_height=h, image_width=w, FoVx=math.radians(60),
              FoVy=2 * math.atan(math.tan(math.radians(30)) * h / w),
              R=rotation_y(0.1), T=np.array([0.05, -0.05, 0.1], np.float32))
    jcam, tcam = jbuild_camera(**kw), tbuild_camera(**kw, device="cpu")
    jm, tm = jax_model(params, degrees), torch_model(params, degrees)
    t_out = tm(tcam, with_stats=True)
    if jax_path == "xla":
        j_out = jm(jcam, with_stats=True)
    else:
        j_out = jrender_tiled(*jm.render_array_args(jm.parameters(), jm.aux_state()),
                              jm.render_settings(jcam), use_pallas=True,
                              pallas_interpret=True, with_stats=True)
    assert not t_out["render"].requires_grad
    np.testing.assert_allclose(t_out["render"].numpy(), np.asarray(j_out["render"]), atol=1e-4)
    count = t_out["gaussians_count"].numpy()
    assert t_out["gaussians_count"].dtype == torch.int32
    np.testing.assert_array_equal(count, np.asarray(j_out["gaussians_count"]))
    np.testing.assert_array_equal(t_out["touched_pixels"].numpy(), count)
    for key in STAT_KEYS:
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    # Pixels outside the image count: the Gaussians' counts exceed the
    # contributing pairs inside the image.
    inside, total = _contributing_pairs(tm, tcam)
    assert count.sum() == total > inside


def _contributing_pairs(model, camera):
    """(pairs inside the image, all pairs) of (pixel, entry) where the entry
    is gated in and before the pixel's latch, over the padded tile grid;
    the per-entry counts of the statistics compositor must sum them."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    settings = model.render_settings(camera)
    tiles_x, tiles_y = common.tile_grid(settings)
    with torch.no_grad():
        pre = common.preprocess(*model.render_array_args(), settings)
    ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                             tiles_x, tiles_y)
    e = tcomp.pack_fields(pre)[:, ent["s_gidx"]].contiguous()
    rs, re = ent["range_start"], ent["range_end"]
    _, _, latch, stats = tcomp.composite_fwd_stats(e, rs, re, tiles_x)
    K = e.shape[1]
    seg = torch.repeat_interleave(torch.arange(rs.numel()), (re - rs).long(), output_size=K)
    p = torch.arange(tconfig.BLOCK_SIZE)[:, None]
    px = (seg % tiles_x) * tconfig.BLOCK_X + p % tconfig.BLOCK_X                # [256,K]
    py = (seg // tiles_x) * tconfig.BLOCK_Y + p // tconfig.BLOCK_X
    dx, dy = e[0] - px.float(), e[1] - py.float()
    A, B, C, op = e[2], e[3], e[4], e[5]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=tconfig.ALPHA_MAX)
    live = (power <= 0) & (alpha >= tconfig.ALPHA_EPS)
    live &= torch.arange(K)[None, :] < latch[..., 0].T[:, seg]
    np.testing.assert_array_equal(live.sum(dim=0).numpy(), stats[0].numpy())
    inside = (px < camera.image_width) & (py < camera.image_height)
    return int((live & inside).sum()), int(live.sum())
