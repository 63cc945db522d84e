"""PyTorch port vs JAX package: gradients of the whole render.

The port's ``VariableSHGaussianModel.render`` (on the CPU: plain preprocess
autograd and the plain backward compositor) and ``jax.grad`` of the JAX
model's ``render``, on its XLA tiled path and on its Pallas path in
interpret mode, differentiate the loss of tests/test_pallas_kernel.py:40-46
(L1 to a target, 0.05 mean depth, 0.05 mean final_T, non-zero background)
with respect to the six raw parameters and the screen-space offset
``mean2d_offset_ndc``. The scenes mix SH degrees 0-3, so degree-masked
coefficients must get exactly zero gradient, and hold large Gaussians just
outside the FoV clamp of ``build_cov2d``. Bars: rtol 2e-3 / atol 3e-5, or
3e-3 / 5e-5 with the latch engaged (the JAX package's own)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.ops import sh as tsh  # noqa: E402
from reduced_3dgs_tpu.dataset.camera import build_camera as jbuild_camera  # noqa: E402

from .test_torch_fixtures import jax_model, random_cloud_np, torch_model  # noqa: E402

H, W = 32, 48
FOVX = math.radians(60)
BG = (0.3, 0.5, 0.7)
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _scene(case):
    if case == "normal":
        params, degrees = random_cloud_np(61, 70, spread=0.8)
        # Four large Gaussians beyond 1.3 tan(fov/2) of the view axis, whose
        # splats still reach into the image.
        params["xyz"][:4, 0] = [2.5, -2.5, 2.6, -2.6]
        params["xyz"][:4, 1] = [0.2, -0.1, 0.0, 0.3]
        params["xyz"][:4, 2] = 3.0
        params["scaling"][:4] = -0.8
        params["opacity"][:4] = 2.0
    else:  # opaque, small spread: many pixels latch
        params, degrees = random_cloud_np(62, 100, spread=0.15, opacity=8.0)
    return params, degrees


def _cameras():
    kw = dict(image_height=H, image_width=W, FoVx=FOVX,
              FoVy=2 * math.atan(math.tan(FOVX / 2) * H / W), bg_color=BG)
    return jbuild_camera(**kw), tbuild_camera(**kw, device="cpu")


def _target():
    return np.linspace(0.0, 1.0, 3 * H * W, dtype=np.float32).reshape(3, H, W)


def _loss(out, target):
    return (abs(out["render"] - target).mean() + 0.05 * out["depth"].mean()
            + 0.05 * out["final_T"].mean())


def _jax_grads(params, degrees, backend, num_rendered):
    """jax.grad of the loss on the JAX model's render, jitted, with a key
    buffer just above the port's entry count (the JAX default would size it
    for every Gaussian in every tile)."""
    jm = jax_model(params, degrees, render_backend=backend)
    jcam, _ = _cameras()
    target = jnp.asarray(_target())
    n = params["xyz"].shape[0]
    key_buffer = 256 * (num_rendered // 256 + 1)

    def f(p, off):
        out = jm.render(p, jcam, aux=jm.aux_state(), mean2d_offset_ndc=off,
                        key_buffer_size=key_buffer)
        return _loss(out, target), out["num_rendered"]

    (gp, goff), jax_rendered = jax.jit(jax.grad(f, argnums=(0, 1), has_aux=True))(
        jm.parameters(), jnp.zeros((n, 2), jnp.float32))
    assert int(jax_rendered) == num_rendered
    return {k: np.asarray(v) for k, v in gp.items()}, np.asarray(goff)


@pytest.fixture(scope="module")
def port_grads():
    """Port gradients of each scene, computed once for both JAX paths."""
    grads = {}
    for case in ("normal", "opaque"):
        params, degrees = _scene(case)
        tm = torch_model(params, degrees)
        _, tcam = _cameras()
        off = torch.zeros((params["xyz"].shape[0], 2), requires_grad=True)
        out = tm.render(tcam, mean2d_offset_ndc=off)
        _loss(out, torch.from_numpy(_target())).backward()
        g = {name: p.grad.numpy() for name, p in tm.param_dict().items()}
        grads[case] = (g, off.grad.numpy(), out, tm)
    return grads


@pytest.mark.parametrize("backend", ["tiled", "pallas"])
@pytest.mark.parametrize("case", ["normal", "opaque"])
def test_render_gradients_match_jax(case, backend, port_grads):
    params, degrees = _scene(case)
    t_grads, t_off, out, tm = port_grads[case]
    j_grads, j_off = _jax_grads(params, degrees, backend, out["num_rendered"])
    rtol, atol = (2e-3, 3e-5) if case == "normal" else (3e-3, 5e-5)
    for name in PARAM_NAMES:
        assert np.abs(j_grads[name]).max() > 0, name
        np.testing.assert_allclose(t_grads[name], j_grads[name], rtol=rtol, atol=atol,
                                   err_msg=f"{case}/{backend}: {name}")
    np.testing.assert_allclose(t_off, j_off, rtol=rtol, atol=atol,
                               err_msg=f"{case}/{backend}: mean2d_offset_ndc")


def test_render_gradient_scene_properties(port_grads):
    """What the parity test relies on: the latch engages in the opaque
    scene, the out-of-FoV Gaussians are clamped and still reach the image
    with a non-zero position gradient, and degree-masked SH coefficients get
    exactly zero gradient while unmasked ones do not."""
    for case in ("normal", "opaque"):
        t_grads, _, out, tm = port_grads[case]
        mask = tsh.degree_coeff_mask(tm._degrees, tm.max_sh_degree).numpy().astype(bool)
        rest = t_grads["features_rest"]
        assert (rest[~mask] == 0).all()
        assert (np.abs(rest[mask]).sum(-1) > 0).mean() > 0.5
        assert (tm._degrees.numpy() < 3).any()
    assert (port_grads["opaque"][2]["final_T"] < 2e-4).any()
    t_grads, t_off, out, tm = port_grads["normal"]
    xyz = tm._xyz.detach().numpy()[:4]
    tanx = math.tan(FOVX / 2)
    assert (np.abs(xyz[:, 0] / xyz[:, 2]) > 1.3 * tanx).all()
    assert (out["radii"][:4].numpy() > 0).all()
    assert (np.abs(t_grads["xyz"][:4]).sum(-1) > 0).all()
    assert (np.abs(t_off[:4]).sum(-1) > 0).all()
