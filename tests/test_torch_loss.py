"""PyTorch port vs JAX package: the training loss and its gradients.

SSIM (JAX default blur mode, banded matmuls), L1 and the photometric loss
of ``BaseTrainer.loss_pure`` with the SH-sparsity term, values and
gradients with respect to their inputs, on the same numpy inputs. Bars:
rtol 1e-5, atol 1e-6."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.models import GaussianModel as TGaussianModel  # noqa: E402
from reduced_3dgs_torch.ops import ssim as tssim_mod  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer as TBaseTrainer  # noqa: E402
from reduced_3dgs_torch.utils.math import l1_loss as tl1  # noqa: E402
from reduced_3dgs_tpu.dataset.camera import build_camera as jbuild_camera  # noqa: E402
from reduced_3dgs_tpu.models import GaussianModel as JGaussianModel  # noqa: E402
from reduced_3dgs_tpu.ops.ssim import ssim as jssim  # noqa: E402
from reduced_3dgs_tpu.trainer import BaseTrainer as JBaseTrainer  # noqa: E402
from reduced_3dgs_tpu.utils.math import l1_loss as jl1  # noqa: E402

from .test_torch_fixtures import random_cloud_np  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _images(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)
    return a, b


def _torch_value_and_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return float(value.detach()), [t.grad.numpy() for t in ts]


def _jax_value_and_grads(fn, *arrays):
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("hw", [(32, 32), (40, 72)])
def test_ssim_value_and_gradient_match_jax(hw):
    a, b = _images(71, *hw)
    tv, tg = _torch_value_and_grads(tssim_mod.ssim, a, b)
    jv, jg = _jax_value_and_grads(jssim, a, b)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    for t, j in zip(tg, jg):
        assert np.abs(j).max() > 1e-5
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_l1_value_and_gradient_match_jax():
    a, b = _images(72, 24, 40)
    b[0, :2, :2] = a[0, :2, :2]  # ties: JAX's subgradient of |d| at 0 is +1
    tv, tg = _torch_value_and_grads(tl1, a, b)
    jv, jg = _jax_value_and_grads(jl1, a, b)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_blur_backward_is_the_convolution_adjoint():
    """The blur's own backward (which keeps the backward convolutions out of
    TF32 on the card) equals autograd through the two convolutions."""
    x = torch.from_numpy(np.random.default_rng(73).normal(size=(5, 20, 28)))
    taps = torch.from_numpy(tssim_mod._gaussian_window_np(11, 1.5)).double()
    g = torch.from_numpy(np.random.default_rng(74).normal(size=(5, 20, 28)))

    xa = x.clone().requires_grad_(True)
    tssim_mod._Blur.apply(xa, taps).backward(g)
    xb = x.clone().requires_grad_(True)
    wy = taps.view(1, 1, 11, 1).expand(5, 1, 11, 1)
    wx = taps.view(1, 1, 1, 11).expand(5, 1, 1, 11)
    y = F.conv2d(F.conv2d(xb[None], wy, padding=(5, 0), groups=5), wx, padding=(0, 5), groups=5)
    y[0].backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_mask", [False, True])
def test_photometric_loss_with_sh_sparsity_matches_jax(with_mask):
    """BaseTrainer.loss_pure with lambda_sh_sparsity > 0: value and
    gradients with respect to the render and features_rest."""
    params, _ = random_cloud_np(75, 12)
    h, w = 24, 32
    render, gt = _images(76, h, w)
    mask = (np.random.default_rng(77).uniform(size=(1, h, w)) > 0.3).astype(np.float32)
    radii = np.array([0, 3, 5, 0, 1, 2, 7, 0, 4, 2, 0, 9], np.int32)
    lam = 0.2
    kw = dict(image_height=h, image_width=w, FoVx=math.radians(60), FoVy=math.radians(45),
              ground_truth_image=gt, ground_truth_image_mask=mask if with_mask else None)

    jm = JGaussianModel(3)
    jm.set_parameters({k: jnp.asarray(v) for k, v in params.items()})
    jloss = JBaseTrainer(jm, None, lambda_sh_sparsity=lam).loss_pure()
    jcam = jbuild_camera(**kw)

    def jf(rend, rest):
        p = dict(jm.parameters(), features_rest=rest)
        return jloss(p, None, {"render": rend, "radii": jnp.asarray(radii)}, jcam, {})

    jv, jg = _jax_value_and_grads(jf, render, params["features_rest"])

    tm = TGaussianModel(3, device="cpu").load_numpy(params)
    tloss = TBaseTrainer(tm, None, lambda_sh_sparsity=lam).loss_pure()
    tcam = tbuild_camera(**kw, device="cpu")

    def tf(rend, rest):
        p = dict(tm.param_dict(), features_rest=rest)
        return tloss(p, {"render": rend, "radii": torch.from_numpy(radii)}, tcam, {})

    tv, tg = _torch_value_and_grads(tf, render, params["features_rest"])
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    for t, j, name in zip(tg, jg, ["render", "features_rest"]):
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)
