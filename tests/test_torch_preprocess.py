"""PyTorch port vs JAX package: common.preprocess, all nine fields."""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops.rasterize import common as tcommon  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import common as jcommon  # noqa: E402

from .test_torch_fixtures import (activated_np, camera_np, jax_args, jax_settings,  # noqa: E402
                                  random_cloud_np, rotation_y, torch_args, torch_settings)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["front_32x32", "rotated_48x80"])
def test_preprocess_fields_match(case):
    if case == "front_32x32":
        params, _ = random_cloud_np(11, 80)
        cam = camera_np(32, 32)
    else:
        # Wide spread: some Gaussians fall off screen, some behind the near
        # plane after the camera's rotation and translation.
        params, _ = random_cloud_np(12, 100, spread=2.5, z_spread=2.6)
        cam = camera_np(48, 80, fovx=math.radians(70), R=rotation_y(0.35),
                        T=(0.3, -0.2, 0.4))
    arrs = activated_np(params)
    jp = jcommon.preprocess(*jax_args(arrs), jax_settings(cam))
    tp = tcommon.preprocess(*torch_args(arrs), torch_settings(cam))
    visible = np.asarray(jp.tiles_touched) > 0
    assert 0 < visible.sum() < len(visible) or case == "front_32x32"
    for name in jcommon.PreprocessedGaussians._fields:
        j = np.asarray(getattr(jp, name))
        t = getattr(tp, name).numpy()
        assert t.shape == j.shape, name
        if j.dtype.kind == "i":
            assert t.dtype == j.dtype, name
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, err_msg=name, **FLOAT_TOL)
