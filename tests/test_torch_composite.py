"""PyTorch port vs JAX package: the forward tile compositor.

The port's plain compositor (what ``composite_fwd`` runs on CPU tensors)
and the JAX package's Pallas kernel ``tile_composite_fwd`` in interpret mode
read the same sorted entry buffer. Bars are the JAX package's own for its
kernel (tests/test_pallas_kernel.py): colour and final_T atol 1e-4, depth
atol 5e-4, latch exact."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops.rasterize import common as tcommon  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import composite as tcomp  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import tiled as ttiled  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import pallas_kernel as pk  # noqa: E402

from .test_torch_fixtures import (activated_np, camera_np, random_cloud_np,  # noqa: E402
                                  torch_args, torch_settings)


def _scene(case):
    if case == "normal":
        params, _ = random_cloud_np(31, 70, spread=0.8)
        cam = camera_np(48, 48, bg=(0.2, 0.4, 0.6))
    elif case == "opaque":
        params, _ = random_cloud_np(32, 100, spread=0.15, opacity=8.0, scale_lo=-2.0,
                                    scale_hi=-1.0)
        cam = camera_np(32, 32)
    else:  # partly empty: the Gaussians sit left of centre
        params, _ = random_cloud_np(33, 50, spread=0.3)
        params["xyz"][:, 0] -= 1.0
        cam = camera_np(48, 64)
    return params, cam


def _sorted_entries(params, cam):
    settings = torch_settings(cam)
    tiles_x, tiles_y = tcommon.tile_grid(settings)
    pre = tcommon.preprocess(*torch_args(activated_np(params)), settings)
    ent = ttiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                              tiles_x, tiles_y)
    e = tcomp.pack_fields(pre)[:, ent["s_gidx"]].contiguous()
    return e, ent["range_start"], ent["range_end"], tiles_x


def _jax_composite(e, range_start, range_end, tiles_x):
    num_tiles = range_start.shape[0]
    k = e.shape[1]
    kpad = max(pk.CHUNK, -(-k // pk.CHUNK) * pk.CHUNK)
    e_pad = np.zeros((tcomp.N_FIELDS, kpad), np.float32)
    e_pad[:, :k] = e.numpy()
    rs, re = jnp.asarray(range_start.numpy()), jnp.asarray(range_end.numpy())
    steps = pk.step_layout(rs, re, kpad, num_tiles)
    color4, final_t, latch = pk.tile_composite_fwd(
        jnp.asarray(e_pad), *steps, 0, tiles_x, num_tiles, interpret=True)
    return (np.asarray(color4)[:num_tiles], np.asarray(final_t)[:num_tiles],
            np.asarray(latch)[:num_tiles])


@pytest.mark.parametrize("case", ["normal", "opaque", "partly_empty"])
def test_plain_compositor_matches_pallas_kernel(case):
    e, rs, re, tiles_x = _sorted_entries(*_scene(case))
    color4, final_t, latch = tcomp.composite_fwd(e, rs, re, tiles_x)
    j_color4, j_final_t, j_latch = _jax_composite(e, rs, re, tiles_x)
    assert color4.shape == j_color4.shape and final_t.shape == j_final_t.shape
    assert latch.dtype == torch.int32

    nonempty = (re - rs > 0).numpy()
    color4, final_t, latch = color4.numpy(), final_t.numpy(), latch.numpy()
    np.testing.assert_allclose(color4[nonempty, :, :3], j_color4[nonempty, :, :3], atol=1e-4)
    np.testing.assert_allclose(color4[nonempty, :, 3], j_color4[nonempty, :, 3], atol=5e-4)
    np.testing.assert_allclose(final_t[nonempty], j_final_t[nonempty], atol=1e-4)
    # "No latch" is range_end in the port and 2^30 in the JAX kernel.
    port_latch = np.where(latch[..., 0] == re.numpy()[:, None], -1, latch[..., 0])
    jax_latch = np.where(j_latch[..., 0] >= pk.BIG, -1, j_latch[..., 0])
    np.testing.assert_array_equal(port_latch[nonempty], jax_latch[nonempty])

    if case == "opaque":
        assert (port_latch >= 0).sum() > 100  # the latch is engaged
    if case == "partly_empty":
        assert 0 < nonempty.sum() < nonempty.size
        assert (color4[~nonempty] == 0).all() and (final_t[~nonempty] == 1).all()
        np.testing.assert_array_equal(latch[~nonempty, :, 0],
                                      np.broadcast_to(re.numpy()[~nonempty, None],
                                                      latch[~nonempty, :, 0].shape))


def test_composite_sorted_gathers_and_refuses_backward():
    """CompositeSorted gathers fields10[:, s_gidx] and composites them. Its
    backward no longer refuses: on CPU tensors it runs the plain backward
    compositor, launches no kernel and reaches the preprocess inputs
    (test_torch_composite_bwd.py holds its values against JAX)."""
    params, cam = _scene("normal")
    settings = torch_settings(cam)
    tiles_x, tiles_y = tcommon.tile_grid(settings)
    arrs = [a.clone().requires_grad_(a.is_floating_point())
            for a in torch_args(activated_np(params))]
    pre = tcommon.preprocess(*arrs, settings)
    ent = ttiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched,
                              pre.depths.detach(), tiles_x, tiles_y)
    fields10 = tcomp.pack_fields(pre)
    color4, final_t = tcomp.CompositeSorted.apply(
        fields10, ent["s_gidx"], ent["range_start"], ent["range_end"], tiles_x)
    ref = tcomp.composite_fwd(fields10.detach()[:, ent["s_gidx"]].contiguous(),
                              ent["range_start"], ent["range_end"], tiles_x)
    np.testing.assert_array_equal(color4.detach().numpy(), ref[0].numpy())
    np.testing.assert_array_equal(final_t.detach().numpy(), ref[1].numpy())
    launches = tcomp.composite_bwd.launches
    color4.sum().backward()
    assert tcomp.composite_bwd.launches == launches
    for a in arrs:
        if a.requires_grad:
            assert a.grad is not None and torch.isfinite(a.grad).all()
    assert arrs[0].grad.abs().sum() > 0
