"""PyTorch port vs JAX package: the whole render and the image metrics.

The port's ``VariableSHGaussianModel`` (mixed per-Gaussian SH degrees)
renders on the CPU, where the compositor runs its plain version, and is held
against the JAX model on its XLA tiled path and on its Pallas path in
interpret mode. Bars: image and final_T atol 1e-4, depth atol 5e-4."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.ops.rasterize.reference import render_reference  # noqa: E402
from reduced_3dgs_torch.ops.ssim import ssim as tssim  # noqa: E402
from reduced_3dgs_torch.utils.math import psnr as tpsnr  # noqa: E402
from reduced_3dgs_tpu.dataset.camera import build_camera as jbuild_camera  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize.tiled import render_tiled as jrender_tiled  # noqa: E402
from reduced_3dgs_tpu.ops.ssim import ssim as jssim  # noqa: E402
from reduced_3dgs_tpu.utils.math import psnr as jpsnr  # noqa: E402

from .test_torch_fixtures import (random_cloud_np, rotation_y, jax_model,  # noqa: E402
                                  torch_model)

BG = (0.2, 0.4, 0.6)


def _cameras(h, w):
    kw = dict(image_height=h, image_width=w, FoVx=math.radians(60),
              FoVy=2 * math.atan(math.tan(math.radians(30)) * h / w),
              R=rotation_y(0.15), T=np.array([0.1, -0.05, 0.2], np.float32), bg_color=BG)
    return jbuild_camera(**kw), tbuild_camera(**kw, device="cpu")


def _assert_render_close(t_out, j_out):
    np.testing.assert_allclose(t_out["render"].numpy(), np.asarray(j_out["render"]), atol=1e-4)
    np.testing.assert_allclose(t_out["final_T"].numpy(), np.asarray(j_out["final_T"]), atol=1e-4)
    np.testing.assert_allclose(t_out["depth"].numpy(), np.asarray(j_out["depth"]), atol=5e-4)
    np.testing.assert_array_equal(t_out["radii"].numpy(), np.asarray(j_out["radii"]))


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("hw", [(32, 32), (48, 80)])
def test_variable_sh_render_matches_jax(hw, jax_path):
    params, degrees = random_cloud_np(41, 70, spread=0.8)
    assert len(set(degrees.tolist())) == 4  # every degree 0..3 present
    jcam, tcam = _cameras(*hw)
    jm = jax_model(params, degrees)
    tm = torch_model(params, degrees)
    with torch.no_grad():
        t_out = tm(tcam)
    if jax_path == "xla":
        j_out = jm(jcam)
    else:
        j_out = jrender_tiled(*jm.render_array_args(jm.parameters(), jm.aux_state()),
                              jm.render_settings(jcam), use_pallas=True,
                              pallas_interpret=True)
    assert t_out["num_rendered"] == int(j_out["num_rendered"])
    assert t_out["render"].shape == (3, *hw)
    _assert_render_close(t_out, j_out)


@pytest.mark.parametrize("hw", [(32, 32), (48, 80)])
def test_dense_oracle_matches_tiled(hw):
    """The port's dense renderer (no binning, no sort of entries) agrees
    with its tiled path."""
    params, degrees = random_cloud_np(42, 60, spread=0.8)
    _, tcam = _cameras(*hw)
    tm = torch_model(params, degrees)
    with torch.no_grad():
        tiled = tm(tcam)
        dense = render_reference(*tm.render_array_args(), tm.render_settings(tcam))
    for k in ("render", "final_T", "depth"):
        np.testing.assert_allclose(tiled[k].numpy(), dense[k].numpy(), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tiled["radii"].numpy(), dense["radii"].numpy())


def _image_pair(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_ssim_matches_jax():
    a, b = _image_pair(43)
    np.testing.assert_allclose(float(tssim(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    assert float(tssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)


def test_psnr_matches_jax():
    a, b = _image_pair(44)
    t = tpsnr(torch.from_numpy(a), torch.from_numpy(b))
    assert t.shape == (3, 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(jpsnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
