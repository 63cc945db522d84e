"""PyTorch port vs JAX package: packed variable-degree SH, rendering with
precomputed colours, and ``mark_visible``.

  * ``pack_variable_sh`` and ``unpack_variable_sh`` equal the JAX
    functions' output exactly; ``packed_num_coeff_rows`` counts the packed
    rows.
  * ``packed_sh_colors`` within 1e-6 of the JAX function's.
  * ``render_packed`` equals the dense render within B1's colour bar
    (1e-4), in both packages, and the port's equals the JAX package's.
  * ``render_tiled(..., colors_precomp=...)``: the image within 1e-4 of
    the JAX package's, and the gradient of a weighted sum of it in the
    colours within the gradient bars (rtol 2e-3, atol 3e-5 of max|g|).
  * ``mark_visible`` exact, after a margin of every view-space z against
    the 0.2 near plane.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.models import packed_sh as tpk  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import common as tcommon  # noqa: E402
from reduced_3dgs_torch.ops.rasterize.tiled import render_tiled as t_render_tiled  # noqa: E402
from reduced_3dgs_tpu.models import packed_sh as jpk  # noqa: E402
from reduced_3dgs_tpu.models.gaussian_model import GaussianModel as JGaussianModel  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import common as jcommon  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize.tiled import render_tiled as j_render_tiled  # noqa: E402

from .test_torch_fixtures import (activated_np, assert_decision_margin,  # noqa: E402
                                  camera_np, jax_dataset, jax_model, jax_settings,
                                  random_cloud_np, rotation_y, torch_dataset, torch_model,
                                  torch_settings)

TOL_COLOR = 1e-4
TOL_SH = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-3, 3e-5
H, W = 40, 56


def packed_pair(seed, n=60):
    params, degrees = random_cloud_np(seed, n)
    return params, degrees, jpk.pack_variable_sh(params, degrees), \
        tpk.pack_variable_sh({k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(degrees))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_and_unpack_match_jax(seed):
    params, degrees, jp, tp = packed_pair(400 + seed)
    assert tp["group_counts"] == jp["group_counts"]
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if k != "group_counts":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)
    assert tp["features_rest_packed"].shape[0] == tpk.packed_num_coeff_rows(degrees) \
        == jpk.packed_num_coeff_rows(degrees) < 15 * len(degrees)
    ju, tu = jpk.unpack_variable_sh(jp), tpk.unpack_variable_sh(tp)
    assert set(tu) == set(ju)
    for k, v in ju.items():
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(v), err_msg=k)


def test_packed_colors_match_jax():
    params, degrees, jp, tp = packed_pair(402)
    cam = camera_np(H, W, R=rotation_y(0.1), T=np.array([0.1, -0.05, 0.2], np.float32))
    jc = jpk.packed_sh_colors(jp, jax_settings(cam).campos)
    tc = tpk.packed_sh_colors(tp, torch_settings(cam).campos)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL_SH, atol=TOL_SH)


def test_render_packed_equals_dense_in_both_packages():
    params, degrees, jp, tp = packed_pair(403)
    cam = camera_np(H, W, R=rotation_y(-0.05), T=np.array([0.05, 0.0, 0.1], np.float32))
    jcam, tcam = jax_dataset([cam])[0], torch_dataset([cam])[0]
    with torch.no_grad():
        t_dense = torch_model(params, degrees)(tcam)["render"].numpy()
        t_packed = tpk.render_packed(tp, tcam)["render"].numpy()
    j_dense = np.asarray(jax_model(params, degrees)(jcam)["render"])
    j_packed = np.asarray(jpk.render_packed(jp, jcam, model=JGaussianModel(3))["render"])
    assert np.abs(t_dense).max() > 0.1
    np.testing.assert_allclose(t_packed, t_dense, atol=TOL_COLOR)
    np.testing.assert_allclose(j_packed, j_dense, atol=TOL_COLOR)
    np.testing.assert_allclose(t_packed, j_packed, atol=TOL_COLOR)


def test_colors_precomp_render_and_gradient_match_jax():
    params, _ = random_cloud_np(404, 60)
    means, opac, scales, rots, _ = activated_np(params)
    rng = np.random.default_rng(405)
    colors = rng.uniform(-0.2, 1.2, (60, 3)).astype(np.float32)
    weights = rng.normal(0.0, 1.0, (3, H, W)).astype(np.float32)
    cam = camera_np(H, W, bg=(0.1, 0.2, 0.3))
    js, ts = jax_settings(cam), torch_settings(cam)
    j_args = [jnp.asarray(a) for a in (means, opac, scales, rots)]

    def j_loss(c):
        out = j_render_tiled(*j_args, jnp.zeros((60, 1, 3)), js, colors_precomp=c)
        return jnp.sum(out["render"] * weights), out["render"]

    (_, j_img), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(colors))
    tc = torch.tensor(colors, requires_grad=True)
    t_img = t_render_tiled(*(torch.from_numpy(a) for a in (means, opac, scales, rots)), None,
                           ts, colors_precomp=tc)["render"]
    torch.sum(t_img * torch.from_numpy(weights)).backward()
    np.testing.assert_allclose(t_img.detach().numpy(), np.asarray(j_img), atol=TOL_COLOR)
    g = np.asarray(j_grad)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(tc.grad.numpy(), g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(g).max())


def test_mark_visible_matches_jax():
    params, degrees = random_cloud_np(406, 200, z_center=0.5, z_spread=1.0)
    views = [camera_np(H, W, R=rotation_y(a), T=np.array([0.0, 0.0, dz], np.float32))
             for a, dz in ((0.0, 0.0), (0.3, -0.2), (-0.2, 0.4))]
    model = torch_model(params, degrees)
    for cam, tcam in zip(views, torch_dataset(views)):
        z = np.asarray(jcommon.proj.world_to_view(jnp.asarray(params["xyz"]),
                                                  jax_settings(cam).viewmatrix))[:, 2]
        assert_decision_margin(z, 0.2)
        want = np.asarray(jcommon.mark_visible(jnp.asarray(params["xyz"]),
                                               jax_settings(cam).viewmatrix))
        assert 0 < want.sum() < len(want)
        np.testing.assert_array_equal(model.mark_visible(tcam).numpy(), want)
        np.testing.assert_array_equal(
            tcommon.mark_visible(torch.from_numpy(params["xyz"]),
                                 tcam.world_view_transform).numpy(), want)
