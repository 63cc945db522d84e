"""Camera datasets (counterpart of reduced_3dgs_tpu/dataset/dataset.py:21-170)."""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .camera import Camera, build_camera, camera_from_json, camera_to_json, focal2fov
from .colmap import load_sparse, qvec2rotmat


class CameraDataset:
    """An ordered collection of cameras with ground-truth images."""

    def __init__(self, cameras: List[Camera], image_names: Optional[List[str]] = None):
        self.cameras = list(cameras)
        self.image_names = image_names or [f"{i:05d}" for i in range(len(cameras))]

    def __len__(self):
        return len(self.cameras)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return CameraDataset(self.cameras[idx], self.image_names[idx])
        return self.cameras[idx]

    def __iter__(self):
        return iter(self.cameras)

    def save_cameras(self, path: str):
        """Write the cameras as a vanilla-3DGS cameras.json."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        entries = [camera_to_json(i, cam, self.image_names[i])
                   for i, cam in enumerate(self.cameras)]
        with open(path, "w") as f:
            json.dump(entries, f)

    def scene_extent(self) -> float:
        """Radius of the camera centres' bounding sphere times 1.1 (vanilla
        3DGS's getNerfppNorm, which sets ``spatial_lr_scale``); 1.0 when the
        cameras coincide."""
        centers = np.stack([c.camera_center.detach().cpu().numpy() for c in self.cameras])
        avg = centers.mean(axis=0)
        return float(np.linalg.norm(centers - avg, axis=1).max() * 1.1) or 1.0

    @classmethod
    def load_cameras(cls, path: str, device="cuda", **overrides):
        """Cameras (without images) from a vanilla-3DGS cameras.json."""
        with open(path) as f:
            entries = json.load(f)
        cams = [camera_from_json(e, device=device, **overrides) for e in entries]
        names = [e.get("img_name", f"{i:05d}") for i, e in enumerate(entries)]
        return cls(cams, names)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)  # [3,H,W]


def _maybe_load_mask(source: str, name: str, shape_hw) -> Optional[np.ndarray]:
    from PIL import Image
    stem = os.path.splitext(name)[0]
    for sub in ("masks", "mask"):
        for ext in (".png", ".jpg", ".jpg.png"):
            p = os.path.join(source, sub, stem + ext)
            if os.path.exists(p):
                with Image.open(p) as img:
                    m = np.asarray(img.convert("L"), np.float32) / 255.0
                if m.shape == tuple(shape_hw):
                    return m[None]
    return None


def _maybe_load_depth(source: str, name: str, shape_hw) -> Optional[np.ndarray]:
    from PIL import Image
    stem = os.path.splitext(name)[0]
    for sub in ("depths", "depth"):
        p = os.path.join(source, sub, stem + ".npy")
        if os.path.exists(p):
            d = np.load(p).astype(np.float32)
            if d.shape == tuple(shape_hw):
                return d
        p = os.path.join(source, sub, stem + ".png")
        if os.path.exists(p):
            with Image.open(p) as img:
                d = np.asarray(img, np.float32)
            if d.shape[:2] == tuple(shape_hw):
                return d
    return None


def colmap_fov(cam) -> tuple:
    """(FoVx, FoVy) of a ColmapCamera."""
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        f = cam.params[0]
        return focal2fov(f, cam.width), focal2fov(f, cam.height)
    if cam.model in ("PINHOLE", "OPENCV"):
        fx, fy = cam.params[0], cam.params[1]
        return focal2fov(fx, cam.width), focal2fov(fy, cam.height)
    raise NotImplementedError(f"COLMAP camera model {cam.model}")


def prepare_dataset(source: str, device="cuda", load_camera: Optional[str] = None,
                    load_mask: bool = True, load_depth: bool = True,
                    image_dir: str = "images",
                    resolution_scale: float = 1.0) -> CameraDataset:
    """Load a COLMAP dataset with its images (and masks and depths where
    present), every tensor on ``device``."""
    if load_camera:
        return CameraDataset.load_cameras(load_camera, device=device)
    colmap_cams, colmap_images, _, _ = load_sparse(source)
    cams, names = [], []
    for iid in sorted(colmap_images.keys()):
        img = colmap_images[iid]
        ccam = colmap_cams[img.camera_id]
        fovx, fovy = colmap_fov(ccam)
        # COLMAP: p_cam = R_colmap @ p + t. Row-vector storage needs
        # M[:3,:3] = R_colmap^T so that p @ M[:3,:3] = R_colmap @ p.
        R_stored = qvec2rotmat(img.qvec).T
        img_path = os.path.join(source, image_dir, img.name)
        gt = mask = depth = None
        h, w = ccam.height, ccam.width
        if os.path.exists(img_path):
            gt = _load_image(img_path)
            h, w = gt.shape[1], gt.shape[2]
            if resolution_scale != 1.0:
                from PIL import Image
                w = int(w * resolution_scale)
                h = int(h * resolution_scale)
                with Image.open(img_path) as im:
                    gt = (np.asarray(im.convert("RGB").resize((w, h)), np.float32) / 255.0
                          ).transpose(2, 0, 1)
            if load_mask:
                mask = _maybe_load_mask(source, img.name, (h, w))
            if load_depth:
                depth = _maybe_load_depth(source, img.name, (h, w))
        cams.append(build_camera(
            image_height=h, image_width=w, FoVx=fovx, FoVy=fovy,
            R=R_stored, T=img.tvec, ground_truth_image=gt,
            ground_truth_image_mask=mask, ground_truth_depth=depth, device=device))
        names.append(os.path.splitext(img.name)[0])
    return CameraDataset(cams, names)
