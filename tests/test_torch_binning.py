"""PyTorch port vs JAX package: binning and the (tile, depth) sort.

Both packages bin the same preprocessed Gaussians (the JAX package's
``preprocess`` output). Depths are random, so no exact depth ties arise:
``lax.sort`` in the JAX package does not promise a stable order."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops.rasterize import tiled as ttiled  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import common as jcommon  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import tiled as jtiled  # noqa: E402

from .test_torch_fixtures import (activated_np, camera_np, jax_args, jax_settings,  # noqa: E402
                                  random_cloud_np, rotation_y)


@pytest.mark.parametrize("case", ["small_32x32", "wide_48x80", "big_splats_64x64"])
def test_bin_and_sort_matches_jax(case):
    if case == "small_32x32":
        params, _ = random_cloud_np(21, 60)
        cam = camera_np(32, 32)
    elif case == "wide_48x80":
        params, _ = random_cloud_np(22, 100, spread=1.5, z_spread=1.5)
        cam = camera_np(48, 80, fovx=math.radians(70), R=rotation_y(-0.2), T=(0.1, 0.1, 0.3))
    else:
        params, _ = random_cloud_np(23, 40, scale_lo=-2.5, scale_hi=-1.5)
        cam = camera_np(64, 64)
    pre = jcommon.preprocess(*jax_args(activated_np(params)), jax_settings(cam))
    tiles_x, tiles_y = jcommon.tile_grid(jax_settings(cam))
    num_tiles = tiles_x * tiles_y
    n = pre.depths.shape[0]
    K = n * num_tiles
    jent = jtiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                               tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_row_offset=jnp.int32(0), K=K)
    jstart, jend = jtiled.tile_ranges_from_rects(pre.rect_min, pre.rect_max,
                                                 pre.tiles_touched, tiles_x, tiles_y,
                                                 jnp.int32(0), K)
    tent = ttiled.bin_and_sort(*(torch.from_numpy(np.array(a)) for a in (
        pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths)), tiles_x, tiles_y)

    total = int(jent["total"])
    assert total > num_tiles  # several entries per tile on average
    assert tent["num_rendered"] == total
    np.testing.assert_array_equal(tent["s_tile"].numpy(), np.asarray(jent["s_tile"])[:total])
    np.testing.assert_array_equal(tent["s_gidx"].numpy(), np.asarray(jent["s_gidx"])[:total])
    np.testing.assert_array_equal(tent["range_start"].numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(tent["range_end"].numpy(), np.asarray(jend))
    assert tent["range_start"].dtype == torch.int32


def test_bin_and_sort_no_entries():
    """Every Gaussian culled: no entries, every tile range empty."""
    z = torch.zeros((5, 2), dtype=torch.int32)
    ent = ttiled.bin_and_sort(z, z, torch.zeros(5, dtype=torch.int32),
                              torch.ones(5), tiles_x=3, tiles_y=2)
    assert ent["num_rendered"] == 0 and ent["s_gidx"].numel() == 0
    assert ent["range_start"].tolist() == [0] * 6 and ent["range_end"].tolist() == [0] * 6
