"""Plain 3DGS training steps: the benchmark's reference for the training
cells. It imports nothing of the program under test.

One step, as the configuration's mode defines it (the reference's
``densify-pruning-shculling`` and ``camera-*`` modes after their events are
over): render the view, take (1 - lambda) L1 + lambda (1 - SSIM) (11-tap
Gaussian window, sigma 1.5, zero padding) plus the scale regulariser
w * mean(max(max_scale / min_scale - cap, 0)), differentiate, add each
visible Gaussian's screen-space gradient norm to the densification
statistics, and apply Adam (betas 0.9, 0.999, eps 1e-15, bias corrections
from the step count in float32). The position's learning rate decays
log-linearly over ``position_lr_max_steps`` from Adam's count before the
step; the others are constant, the higher SH bands at feature_lr / 20. A
trainable camera moves by a delta (a quaternion and a translation in view
space) with an Adam of its own, fresh for a camera not stepped before.

L1's |d| takes the subgradient +1 at d = 0 and the alpha clamp passes no
gradient at exactly 0.99, as the configuration's reference (JAX's abs and
strict compare) does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-15


def _window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device).to(dtype)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [C,H,W] images (zero 'same' padding)."""
    c = a.shape[0]
    taps = _window(a.dtype, a.device)
    n = taps.numel()
    x = torch.cat([a, b, a * a, b * b, a * b])[None]
    m = x.shape[1]
    x = F.conv2d(x, taps.view(1, 1, n, 1).expand(m, 1, n, 1), padding=(n // 2, 0), groups=m)
    x = F.conv2d(x, taps.view(1, 1, 1, n).expand(m, 1, 1, n), padding=(0, n // 2), groups=m)
    mu1, mu2, s11, s22, s12 = x[0].split(c)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * (s12 - mu1 * mu2) + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * ((s11 - mu1 * mu1) + (s22 - mu2 * mu2) + c2)
    return torch.mean(num / den)


def photometric(image, gt, lam: float):
    d = image - gt
    l1 = torch.mean(torch.where(d >= 0, d, -d))
    return (1.0 - lam) * l1 + lam * (1.0 - ssim(image, gt))


def scale_reg(scaling, weight: float, cap: float):
    s = torch.exp(scaling)
    ratio = s.max(dim=1).values / torch.clamp(s.min(dim=1).values, min=1e-12)
    return weight * torch.mean(torch.clamp(ratio - cap, min=0.0))


def quat_delta_matrix(q, t):
    """[[R(q / |q|)^T, 0], [t, 1]]: a view-space delta in row-vector storage."""
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    rot_t = R._quat_rot(q).T
    top = torch.cat([rot_t, torch.zeros_like(rot_t[:, :1])], dim=1)
    return torch.cat([top, torch.cat([t, torch.ones_like(t[:1])])[None]], dim=0)


def adam(p, g, m, v, count: int, lr):
    """In place; ``count`` is the step count after this step."""
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32), t))
    bc2 = float(1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32), t))
    m.mul_(B1).add_(g, alpha=1.0 - B1)
    v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
    p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))


def xyz_lr(lr: dict, extent: float, count: int) -> float:
    """The position's rate at Adam's count before the step, in float32."""
    t = torch.clamp(torch.tensor(count, dtype=torch.float32) / lr["position_lr_max_steps"],
                    0.0, 1.0)
    lo = math.log(lr["position_lr_init"] * extent)
    hi = math.log(lr["position_lr_final"] * extent)
    return float(torch.exp(torch.tensor(lo, dtype=torch.float32) * (1.0 - t)
                           + torch.tensor(hi, dtype=torch.float32) * t))


def scene_extent(centers: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre from their mean
    (vanilla 3DGS's getNerfppNorm)."""
    return float(np.linalg.norm(centers - centers.mean(0), axis=1).max() * 1.1) or 1.0


def step(params: dict, degrees, view_args: dict, gt, cfg: dict, dtype=torch.float32,
         camera: bool = False):
    """One step's loss and gradients at ``params`` (not updated here):
    (loss, grads by parameter name, the screen-space gradient norm of the
    visible Gaussians [N] (0 elsewhere), and the camera delta's gradients or
    None). ``view_args`` = rot, t, height, width, fovx, fovy."""
    loss_cfg = cfg["loss"]
    device = params["xyz"].device
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    n = leaves["xyz"].shape[0]
    offset = torch.zeros((n, 2), dtype=torch.float32, device=device, requires_grad=True)
    base = R.make_view(view_args["rot"], view_args["t"], view_args["height"],
                       view_args["width"], view_args["fovx"], view_args["fovy"],
                       device=device, dtype=dtype)
    cam = None
    if camera:
        cam = {"rot": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device, requires_grad=True),
               "trans": torch.zeros(3, device=device, requires_grad=True)}
        wv = base.world_view.float() @ quat_delta_matrix(cam["rot"], cam["trans"])
        view = R.view_from_world_view(wv, base.height, base.width, base.fovx, base.fovy,
                                      dtype=dtype, proj=base.proj.float())
    else:
        view = base
    pre = R.preprocess(leaves, degrees, view, offset=offset, dtype=dtype)
    bins = R.bin_entries(pre, view)
    groups = R.tile_groups(bins)
    image = R.render_forward(pre["fields"].detach(), bins, view, groups=groups)["render"]
    image = image.detach().requires_grad_(True)
    photo = photometric(image, gt.to(dtype), loss_cfg["lambda_dssim"])
    g_image, = torch.autograd.grad(photo, image)
    g_fields = R.render_backward(pre["fields"], bins, view, g_image, groups=groups)
    reg = scale_reg(leaves["scaling"], loss_cfg["scale_reg_weight"],
                    loss_cfg["scale_reg_max_ratio"])
    torch.autograd.backward([pre["fields"], reg], [g_fields, torch.ones_like(reg)])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).float()
             for k, v in leaves.items()}
    screen = torch.where(pre["radii"] > 0, torch.linalg.vector_norm(offset.grad.float(), dim=-1),
                         torch.zeros((n,), device=device))
    cam_grads = None if cam is None else {k: v.grad.float() for k, v in cam.items()}
    return float(photo.detach() + reg.detach()), grads, screen, cam_grads


def train(params0: dict, degrees, views: list, gts: list, cfg: dict, extent: float,
          count0: int, dtype=torch.float32, camera: bool = False) -> dict:
    """Steps over ``views`` (one each) from ``params0`` with a fresh Adam
    at ``count0``: the losses, the first and the last step's gradients, the
    parameters after the last step, the densification sums, and with
    ``camera`` each camera's learned world_view after its step."""
    lr = cfg["learning_rates"]
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    accum = torch.zeros(params["xyz"].shape[0], device=params["xyz"].device)
    losses, first_grads, poses = [], None, []
    count = count0
    for view_args, gt in zip(views, gts):
        loss, grads, screen, cam_grads = step(params, degrees, view_args, gt, cfg, dtype,
                                              camera)
        losses.append(loss)
        if first_grads is None:
            first_grads = grads
        rates = {"xyz": xyz_lr(lr, extent, count), "features_dc": lr["feature_lr"],
                 "features_rest": lr["feature_lr"] / 20.0, "opacity": lr["opacity_lr"],
                 "scaling": lr["scaling_lr"], "rotation": lr["rotation_lr"]}
        count += 1
        with torch.no_grad():
            for k in PARAM_NAMES:
                adam(params[k], grads[k], m[k], v2[k], count, rates[k])
            accum += screen
            if camera:
                delta = {"rot": torch.tensor([1.0, 0.0, 0.0, 0.0], device=accum.device),
                         "trans": torch.zeros(3, device=accum.device)}
                for k, rate in (("rot", lr["camera_rotation_lr"]),
                                ("trans", lr["camera_position_lr"])):
                    adam(delta[k], cam_grads[k], torch.zeros_like(delta[k]),
                         torch.zeros_like(delta[k]), 1, rate)
                base = R.make_view(view_args["rot"], view_args["t"], view_args["height"],
                                   view_args["width"], view_args["fovx"], view_args["fovy"],
                                   device=accum.device)
                poses.append(base.world_view @ quat_delta_matrix(delta["rot"], delta["trans"]))
    out = {"losses": losses, "grads": first_grads, "last_grads": grads, "params": params,
           "accum": accum}
    if camera:
        out["poses"] = poses
    return out
