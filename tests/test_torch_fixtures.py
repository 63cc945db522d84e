"""Shared numpy builders for the PyTorch-port parity tests.

Scenes and cameras are made with numpy from a seed and handed to both
packages: ``jax_*`` helpers build the JAX package's inputs, ``torch_*``
helpers the port's. This module holds no tests.
"""
import math

import numpy as np


def random_cloud_np(seed, n, spread=0.5, z_center=3.0, z_spread=0.8,
                    scale_lo=-4.5, scale_hi=-2.5, opacity=None, max_sh_degree=3):
    """Raw (unactivated) parameters of n Gaussians in front of the default
    camera, as the JAX package's parameter dict, plus mixed SH degrees."""
    rng = np.random.default_rng(seed)
    m = (max_sh_degree + 1) ** 2
    xyz = np.concatenate([
        rng.uniform(-spread, spread, (n, 2)),
        z_center + rng.uniform(-z_spread, z_spread, (n, 1))], axis=1)
    feats = rng.normal(0.0, 0.3, (n, m, 3))
    feats[:, 0, :] += 0.5
    op = (rng.uniform(-1.0, 3.0, (n, 1)) if opacity is None
          else np.full((n, 1), float(opacity)))
    params = dict(
        xyz=xyz,
        features_dc=feats[:, :1],
        features_rest=feats[:, 1:],
        scaling=rng.uniform(scale_lo, scale_hi, (n, 3)),
        rotation=rng.normal(0.0, 0.1, (n, 4)) + np.array([1.0, 0, 0, 0]),
        opacity=op)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    degrees = rng.integers(0, max_sh_degree + 1, n).astype(np.int32)
    return params, degrees


def rotation_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def camera_np(height, width, fovx=math.radians(60), R=None, T=None, bg=(0.0, 0.0, 0.0)):
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    R = np.eye(3, dtype=np.float32) if R is None else np.asarray(R, np.float32)
    T = np.zeros(3, np.float32) if T is None else np.asarray(T, np.float32)
    return dict(height=height, width=width, fovx=fovx, fovy=fovy, R=R, T=T,
                bg=np.asarray(bg, np.float32))


def activated_np(params):
    """(means3d, opacity logits, scales, normalised rotations, features)."""
    rot = params["rotation"]
    rot = rot / np.sqrt(np.sum(rot * rot, axis=-1, keepdims=True) + 1e-24)
    return (params["xyz"], params["opacity"], np.exp(params["scaling"]).astype(np.float32),
            rot.astype(np.float32),
            np.concatenate([params["features_dc"], params["features_rest"]], axis=1))


def jax_settings(cam, sh_degree=3):
    from .helpers import make_settings
    return make_settings(cam["height"], cam["width"], fovx=cam["fovx"], fovy=cam["fovy"],
                         R=cam["R"], T=cam["T"], bg=tuple(cam["bg"]), sh_degree=sh_degree)


def torch_settings(cam, sh_degree=3):
    """Port settings built the way tests/helpers.make_settings builds JAX's."""
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.ops.rasterize.common import RenderSettings
    c = build_camera(cam["height"], cam["width"], cam["fovx"], cam["fovy"], R=cam["R"],
                     T=cam["T"], bg_color=cam["bg"], device="cpu")
    return RenderSettings(
        image_height=cam["height"], image_width=cam["width"],
        tanfovx=math.tan(cam["fovx"] / 2), tanfovy=math.tan(cam["fovy"] / 2),
        bg=c.bg_color, scale_modifier=1.0, viewmatrix=c.world_view_transform,
        projmatrix=c.full_proj_transform, campos=c.camera_center, sh_degree=sh_degree)


def jax_args(arrays):
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in arrays)


def torch_args(arrays):
    import torch
    return tuple(torch.as_tensor(a) for a in arrays)


def jax_model(params, degrees, render_backend="tiled"):
    import jax.numpy as jnp
    from reduced_3dgs_tpu.shculling import VariableSHGaussianModel
    model = VariableSHGaussianModel(3, render_backend=render_backend)
    model.set_parameters({k: jnp.asarray(v) for k, v in params.items()})
    model.aux_set({"degrees": jnp.asarray(degrees)})
    return model


def torch_model(params, degrees):
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    return VariableSHGaussianModel(3, device="cpu").load_numpy(params, degrees)


def views_np(n_views, height, width):
    """Camera dicts of ``n_views`` views turning about y around the default
    camera, with small translations."""
    return [camera_np(height, width, R=rotation_y(0.08 * (i - (n_views - 1) / 2)),
                      T=np.array([0.05 * i, -0.03 * i, 0.02 * i], np.float32))
            for i in range(n_views)]


def jax_dataset(cams, images=None, depths=None):
    """``depths``, when given, holds a [H,W] ground-truth depth or None per
    camera."""
    import jax.numpy as jnp
    from reduced_3dgs_tpu.dataset import CameraDataset, build_camera
    return CameraDataset([
        build_camera(image_height=c["height"], image_width=c["width"], FoVx=c["fovx"],
                     FoVy=c["fovy"], R=c["R"], T=c["T"],
                     **({} if images is None else {"ground_truth_image": images[i]}),
                     **({} if depths is None or depths[i] is None
                        else {"ground_truth_depth": jnp.asarray(depths[i])}))
        for i, c in enumerate(cams)])


def torch_dataset(cams, images=None, depths=None):
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.dataset.dataset import CameraDataset
    return CameraDataset([
        build_camera(c["height"], c["width"], c["fovx"], c["fovy"], R=c["R"], T=c["T"],
                     ground_truth_image=None if images is None else images[i],
                     ground_truth_depth=None if depths is None else depths[i], device="cpu")
        for i, c in enumerate(cams)])


def assert_decision_margin(score, threshold, rel=1e-5):
    """No score lies within ``rel`` (relative) of ``threshold`` unless it
    equals it exactly, so that the decisions ``score <= threshold`` and
    ``score < threshold`` cannot flip between two implementations whose
    scores differ by less than that."""
    score = np.asarray(score, np.float64)
    d = np.abs(score - float(threshold))
    near = (d > 0) & (d <= rel * max(abs(float(threshold)), 1e-12))
    assert not near.any(), (float(threshold), score[near])
