"""Camera datasets (counterpart of reduced_3dgs_tpu/dataset/dataset.py:21-170).

``prepare_dataset(load_camera=...)`` reads the poses from a cameras.json and,
where the source holds an image of the same name, its image, mask and depth
too, so that a run or a render can use learned poses against the ground
truth. (The JAX package's loader leaves them out, so its
``train --load_camera`` has no image to fit.)
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import List, Optional

import numpy as np

from .camera import (Camera, as_tensor, build_camera, camera_from_json, camera_to_json,
                     focal2fov)
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
            return type(self)(self.cameras[idx], self.image_names[idx])
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


class TrainableCameraDataset(CameraDataset):
    """Dataset whose poses the camera trainer refines. The learned deltas
    live in the trainer (``trainer.camera_trainer.CameraTrainer``), keyed by
    each stored camera object, so the cameras here stay the start poses;
    ``replace`` writes a camera back."""

    def replace(self, idx: int, camera: Camera):
        self.cameras[idx] = camera
        return self


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


def _view_images(source: str, image_dir: str, name: str, hw, resolution_scale: float,
                 load_mask: bool, load_depth: bool):
    """(image, mask, depth, (h, w)) of the image file ``name`` under
    ``source/image_dir``; all None and ``hw`` unchanged where it is missing."""
    img_path = os.path.join(source, image_dir, name)
    gt = mask = depth = None
    h, w = hw
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
            mask = _maybe_load_mask(source, name, (h, w))
        if load_depth:
            depth = _maybe_load_depth(source, name, (h, w))
    return gt, mask, depth, (h, w)


def _with_images(dataset: CameraDataset, source: str, image_dir: str, device,
                 resolution_scale: float, load_mask: bool, load_depth: bool) -> CameraDataset:
    """``dataset`` (from a cameras.json) with the image, mask and depth of
    each view whose name matches an image file of the source. A matched
    image whose size (after ``resolution_scale``) is not the view's raises
    ValueError; views without a matching file keep no image, with a
    warning that names them."""
    folder = os.path.join(source, image_dir)
    files = ({os.path.splitext(f)[0]: f for f in sorted(os.listdir(folder))}
             if os.path.isdir(folder) else {})
    missing = []
    for i, (cam, name) in enumerate(zip(dataset.cameras, dataset.image_names)):
        if name not in files:
            missing.append(name)
            continue
        hw_cam = (cam.image_height, cam.image_width)
        gt, mask, depth, hw = _view_images(source, image_dir, files[name], hw_cam,
                                           resolution_scale, load_mask, load_depth)
        if hw != hw_cam:
            raise ValueError(f"image {files[name]!r} is {hw[0]}x{hw[1]} at resolution scale "
                             f"{resolution_scale}, but its camera is {hw_cam[0]}x{hw_cam[1]}")
        dataset.cameras[i] = dataclasses.replace(
            cam, ground_truth_image=as_tensor(gt, device),
            ground_truth_image_mask=as_tensor(mask, device),
            ground_truth_depth=as_tensor(depth, device))
    if missing:
        warnings.warn(f"no image in {folder!r} for the camera(s) {missing}; "
                      "they have no ground truth")
    return dataset


def prepare_dataset(source: str, device="cuda", trainable_camera: bool = False,
                    load_camera: Optional[str] = None, load_mask: bool = True,
                    load_depth: bool = True, image_dir: str = "images",
                    resolution_scale: float = 1.0) -> CameraDataset:
    """Load a COLMAP dataset with its images (and masks and depths where
    present), every tensor on ``device``; a ``TrainableCameraDataset`` with
    ``trainable_camera``. With ``load_camera`` the poses come from that
    cameras.json, and the images from the source where their names match."""
    cls = TrainableCameraDataset if trainable_camera else CameraDataset
    if load_camera:
        return _with_images(cls.load_cameras(load_camera, device=device), source, image_dir,
                            device, resolution_scale, load_mask, load_depth)
    colmap_cams, colmap_images, _, _ = load_sparse(source)
    cams, names = [], []
    for iid in sorted(colmap_images.keys()):
        img = colmap_images[iid]
        ccam = colmap_cams[img.camera_id]
        fovx, fovy = colmap_fov(ccam)
        # COLMAP: p_cam = R_colmap @ p + t. Row-vector storage needs
        # M[:3,:3] = R_colmap^T so that p @ M[:3,:3] = R_colmap @ p.
        R_stored = qvec2rotmat(img.qvec).T
        gt, mask, depth, (h, w) = _view_images(source, image_dir, img.name,
                                               (ccam.height, ccam.width), resolution_scale,
                                               load_mask, load_depth)
        cams.append(build_camera(
            image_height=h, image_width=w, FoVx=fovx, FoVy=fovy,
            R=R_stored, T=img.tvec, ground_truth_image=gt,
            ground_truth_image_mask=mask, ground_truth_depth=depth, device=device))
        names.append(os.path.splitext(img.name)[0])
    return cls(cams, names)
