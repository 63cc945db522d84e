"""Camera record and constructors (counterpart of
reduced_3dgs_tpu/dataset/camera.py:20-150).

Matrices are stored in the row-vector convention of ops/projection.py. A
camera also keeps its projection matrix (``full_proj = world_view @
projection_matrix``), which the camera trainer applies to a learned pose.
``sweep_cameras`` builds an event sweep's camera list once per event, and
``stackable`` says whether one fixed-shape sweep body serves all of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops import projection as proj


@dataclasses.dataclass
class Camera:
    image_height: int
    image_width: int
    FoVx: float
    FoVy: float
    R: torch.Tensor                      # [3,3] stored world->view rotation block
    T: torch.Tensor                      # [3] view-space translation
    world_view_transform: torch.Tensor   # [4,4] row-vector
    full_proj_transform: torch.Tensor    # [4,4] row-vector
    camera_center: torch.Tensor          # [3]
    bg_color: torch.Tensor               # [3]
    ground_truth_image: Optional[torch.Tensor] = None       # [3,H,W]
    ground_truth_image_mask: Optional[torch.Tensor] = None  # [1,H,W]
    ground_truth_depth: Optional[torch.Tensor] = None       # [H,W]
    projection_matrix: Optional[torch.Tensor] = None        # [4,4] row-vector


def as_tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    # np.array copies: a read-only source array cannot back a tensor.
    return torch.as_tensor(np.array(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def build_camera(image_height: int, image_width: int, FoVx: float, FoVy: float,
                 R=None, T=None, bg_color=(0.0, 0.0, 0.0),
                 ground_truth_image=None, ground_truth_image_mask=None,
                 ground_truth_depth=None, znear: float = 0.01, zfar: float = 100.0,
                 device="cuda") -> Camera:
    """Camera with its derived transforms, every tensor on ``device``."""
    device = torch.device(device)
    R = torch.eye(3, device=device) if R is None else as_tensor(R, device)
    T = torch.zeros(3, device=device) if T is None else as_tensor(T, device)
    world_view = proj.world_view_transform_from_rt(R, T)
    projm = proj.build_projection_matrix(znear, zfar, float(FoVx), float(FoVy), device=device)
    return Camera(
        image_height=int(image_height),
        image_width=int(image_width),
        FoVx=float(FoVx),
        FoVy=float(FoVy),
        R=R, T=T,
        world_view_transform=world_view,
        full_proj_transform=world_view @ projm,
        camera_center=proj.camera_center_from_world_view(world_view),
        bg_color=as_tensor(bg_color, device),
        ground_truth_image=as_tensor(ground_truth_image, device),
        ground_truth_image_mask=as_tensor(ground_truth_image_mask, device),
        ground_truth_depth=as_tensor(ground_truth_depth, device),
        projection_matrix=projm,
    )


def resized_camera(camera: Camera, resize: Optional[int], device) -> Camera:
    """``camera`` at its aspect ratio with ``resize`` pixels along its
    longer side, without images (itself when ``resize`` is None)."""
    if resize is None:
        return camera
    height, width = camera.image_height, camera.image_width
    scale = resize / max(height, width)
    return build_camera(int(height * scale), int(width * scale), camera.FoVx, camera.FoVy,
                        R=camera.R, T=camera.T, device=device)


def sweep_cameras(cameras, resize: Optional[int] = None, device=None) -> list:
    """An event sweep's cameras, built once per event: each without its
    ground truth (a sweep reads none), and resized once with
    ``resized_camera`` when ``resize`` is given."""
    return [dataclasses.replace(resized_camera(c, resize, device or c.R.device),
                                ground_truth_image=None, ground_truth_image_mask=None,
                                ground_truth_depth=None)
            for c in cameras]


def stackable(cameras) -> bool:
    """True when the cameras share one image size, so that one fixed-shape
    sweep body serves them all (JAX dataset/camera.py:143-150); a single
    camera is stackable, none is not."""
    cams = list(cameras)
    if len(cams) < 2:
        return len(cams) == 1
    h, w = cams[0].image_height, cams[0].image_width
    return all(c.image_height == h and c.image_width == w for c in cams)


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def camera_to_json(idx: int, camera: Camera, img_name: str = "") -> dict:
    """Vanilla-3DGS cameras.json entry: the camera-to-world position and
    rotation, and the focal lengths."""
    W2C = np.eye(4, dtype=np.float64)
    # Row-vector storage: the column-vector rotation is the transpose.
    W2C[:3, :3] = camera.R.detach().cpu().numpy().T
    W2C[:3, 3] = camera.T.detach().cpu().numpy()
    C2W = np.linalg.inv(W2C)
    return {
        "id": idx,
        "img_name": img_name or f"{idx:05d}",
        "width": camera.image_width,
        "height": camera.image_height,
        "position": C2W[:3, 3].tolist(),
        "rotation": [r.tolist() for r in C2W[:3, :3]],
        "fy": fov2focal(camera.FoVy, camera.image_height),
        "fx": fov2focal(camera.FoVx, camera.image_width),
    }


def camera_from_json(entry: dict, device="cuda", **overrides) -> Camera:
    C2W = np.eye(4)
    C2W[:3, :3] = np.array(entry["rotation"], np.float64)
    C2W[:3, 3] = np.array(entry["position"], np.float64)
    W2C = np.linalg.inv(C2W)
    kwargs = dict(
        image_height=entry["height"], image_width=entry["width"],
        FoVx=focal2fov(entry["fx"], entry["width"]),
        FoVy=focal2fov(entry["fy"], entry["height"]),
        R=W2C[:3, :3].T, T=W2C[:3, 3], device=device)
    kwargs.update(overrides)
    return build_camera(**kwargs)
