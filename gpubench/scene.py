"""The benchmark's inputs, made from ``--seed``: a truck-scale scene of
Gaussians on the card, the orbit of training views, the model a run starts
from, and the order of the traffic.

The scene is a frozen copy of the convergence proof's surfaces (a torus, a
sphere and a checkered ground, ``reduced_3dgs_torch/tools/
convergence_proof.py:surface_cloud``), scaled up to the configuration's
Gaussian count: each surface keeps its share of the points, colours are the
same smooth functions of position, and every Gaussian is isotropic with a
scale of ``splat_per_spacing`` times its surface's analytic point spacing
sqrt(area / count). Higher SH bands carry a small random view dependence.
The weights are made on the device from one ``torch.Generator`` in a few
large calls; the same seed gives the same tensors on the same device.

Every seed gives the same sizes: the same N, views and image size; only the
positions, colours, the perturbation and the order of the views change.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")

# Surfaces of convergence_proof.surface_cloud: torus (R0, r0), sphere
# (centre, radius), ground (half extent, height), and their point shares.
TORUS_R0, TORUS_R1 = 1.6, 0.55
SPHERE_C, SPHERE_R = (0.0, 1.4, 0.0), 0.8
GROUND_HALF, GROUND_Y = 4.0, -1.2
SHARES = (0.45, 0.30)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any size: it is
    folded into 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def gt_scene(scene: dict, n: int, seed: int, device) -> dict:
    """The ground-truth Gaussians: raw parameters as the 3DGS model stores
    them (log scales, logit opacities), and ``spacing`` [N], each point's
    surface spacing."""
    g = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    n_t, n_s = int(n * SHARES[0]), int(n * SHARES[1])
    n_g = n - n_t - n_s
    u = torch.rand((n, 4), generator=g, **f32)
    normal = torch.randn((n, 3), generator=g, **f32)
    two_pi = 2 * math.pi

    a, b = u[:n_t, 0] * two_pi, u[:n_t, 1] * two_pi
    ring = TORUS_R0 + TORUS_R1 * torch.cos(b)
    torus = torch.stack([ring * torch.cos(a), TORUS_R1 * torch.sin(b), ring * torch.sin(a)], -1)
    tor_col = torch.stack([0.5 + 0.45 * torch.cos(a), 0.5 + 0.45 * torch.sin(2 * b),
                           0.5 + 0.45 * torch.sin(a + b)], -1)

    d = normal[n_t:n_t + n_s]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    sphere = torch.tensor(SPHERE_C, **f32) + SPHERE_R * d
    sph_col = 0.5 + 0.45 * d[:, [1, 2, 0]]

    gx = (u[n_t + n_s:, 0] * 2 - 1) * GROUND_HALF
    gz = (u[n_t + n_s:, 1] * 2 - 1) * GROUND_HALF
    ground = torch.stack([gx, torch.full_like(gx, GROUND_Y), gz], -1)
    checker = torch.remainder(torch.floor(gx) + torch.floor(gz), 2)
    gnd_col = torch.stack([0.25 + 0.5 * checker, 0.35 + 0.3 * checker,
                           0.45 - 0.2 * checker], -1)

    xyz = torch.cat([torus, sphere, ground])
    col = torch.clamp(torch.cat([tor_col, sph_col, gnd_col]), 0.02, 0.98)
    areas = (4 * math.pi ** 2 * TORUS_R0 * TORUS_R1, 4 * math.pi * SPHERE_R ** 2,
             (2 * GROUND_HALF) ** 2)
    spacing = torch.cat([torch.full((m,), math.sqrt(ar / m), **f32)
                         for ar, m in zip(areas, (n_t, n_s, n_g))])
    n_rest = (scene["sh_degree"] + 1) ** 2 - 1
    rest = scene["rest_sigma"] * torch.randn((n, n_rest, 3), generator=g, **f32)
    opacity = scene["opacity_min"] + (scene["opacity_max"] - scene["opacity_min"]) * u[:, 2]
    rotation = torch.randn((n, 4), generator=g, **f32)
    params = {
        "xyz": xyz,
        "features_dc": ((col - 0.5) / 0.28209479177387814)[:, None, :],
        "features_rest": rest,
        "scaling": torch.log(scene["splat_per_spacing"] * spacing)[:, None].repeat(1, 3),
        "rotation": rotation / torch.linalg.vector_norm(rotation, dim=-1, keepdim=True),
        "opacity": torch.log(opacity / (1 - opacity))[:, None],
    }
    return {"params": params, "spacing": spacing}


def perturbed(gt: dict, sigma: dict, seed: int) -> dict:
    """The model a run starts from: every parameter moved by Gaussian
    noise of ``sigma[name]`` (the xyz sigma in units of each point's
    spacing), as chip_smoke.perturbed moves the bench scene."""
    g = generator(seed + 1, gt["spacing"].device)
    out = {}
    for name in PARAM_NAMES:
        v = gt["params"][name]
        noise = torch.randn(v.shape, generator=g, dtype=v.dtype, device=v.device)
        scale = sigma[name] * (gt["spacing"][:, None] if name == "xyz" else 1.0)
        out[name] = (v + scale * noise).contiguous()
    return out


def sh_degrees(n: int, shares, seed: int, device) -> torch.Tensor:
    """[N] int32 SH degrees, each Gaussian drawn with the cumulative
    ``shares`` of degrees 0, 1, 2, 3."""
    u = torch.rand((n,), generator=generator(seed + 2, device), device=device)
    edges = torch.tensor(np.cumsum(shares)[:-1], dtype=torch.float32, device=device)
    return torch.bucketize(u, edges, right=True).to(torch.int32)


def orbit_views(views: dict, height: int, width: int):
    """The training views: ``count`` cameras on an orbit of ``radius``
    around the origin whose elevation waves ``waves`` times a turn, all with
    ``fovx_deg``. Returns a list of (rot_w2c [3,3], t_w2c [3]) float64 numpy
    column-vector world-to-view maps, and (fovx, fovy). The same for every
    seed."""
    fovx = math.radians(views["fovx_deg"])
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    poses = []
    for i in range(views["count"]):
        ang = 2 * math.pi * i / views["count"]
        el = views["elevation"] + views["elevation_wave"] * math.sin(views["waves"] * ang)
        C = views["radius"] * np.array([math.cos(ang) * math.cos(el), math.sin(el),
                                        math.sin(ang) * math.cos(el)])
        fwd = -C / np.linalg.norm(C)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])
        poses.append((rot, -rot @ C))
    return poses, (fovx, fovy)


def moved_pose(pose, rot_sigma: float, trans_sigma: float, rng: np.random.Generator):
    """``pose`` moved by a small random rotation (axis-angle of
    ``rot_sigma`` radians per axis) and translation (``trans_sigma`` per
    axis) in view space: the start pose of a trainable camera."""
    rot, t = pose
    w = rng.normal(0.0, rot_sigma, 3)
    angle = np.linalg.norm(w)
    k = w / max(angle, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    dR = np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K
    return dR @ rot, dR @ t + rng.normal(0.0, trans_sigma, 3)


def epoch_orders(n_views: int, seed: int):
    """The view order of each epoch, as ``train.training`` shuffles it:
    one ``random.Random`` of the seed, shuffled again each epoch."""
    rng = random.Random(seed)
    order = list(range(n_views))
    while True:
        rng.shuffle(order)
        yield list(order)
