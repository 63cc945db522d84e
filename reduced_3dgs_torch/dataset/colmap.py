"""COLMAP sparse-model parsing, binary and text, and the model's start
from the sparse points (counterpart of reduced_3dgs_tpu/dataset/colmap.py;
numpy only)."""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray      # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def _read(f, n: int) -> bytes:
    """The next n bytes of ``f``; EOFError where the file ends first."""
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"{f.name} ends {n - len(b)} bytes early")
    return b


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", _read(f, 8))[0]
        for _ in range(num):
            cid, model_id, w, h = struct.unpack("<iiQQ", _read(f, 24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack("<" + "d" * n_params, _read(f, 8 * n_params)))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    """images.bin; EOFError where the file ends early, inside an image name
    too (where the JAX package's reader loops forever)."""
    images = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", _read(f, 8))[0]
        for _ in range(num):
            iid = struct.unpack("<i", _read(f, 4))[0]
            qvec = np.array(struct.unpack("<dddd", _read(f, 32)))
            tvec = np.array(struct.unpack("<ddd", _read(f, 24)))
            cam_id = struct.unpack("<i", _read(f, 4))[0]
            name = b""
            while True:
                c = _read(f, 1)
                if c == b"\x00":
                    break
                name += c
            n_pts = struct.unpack("<Q", _read(f, 8))[0]
            _read(f, 24 * n_pts)  # skip the 2D points
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode("utf-8"))
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz, rgb) of a points3D.bin: through the native parser where it is
    built and reads the file whole, else here (which raises EOFError on a
    file that ends early)."""
    from ..models import native_io
    out = native_io.read_colmap_points_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        num = struct.unpack("<Q", _read(f, 8))[0]
        xyz = np.empty((num, 3), np.float64)
        rgb = np.empty((num, 3), np.uint8)
        for i in range(num):
            data = struct.unpack("<QdddBBBd", _read(f, 43))
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            track_len = struct.unpack("<Q", _read(f, 8))[0]
            _read(f, 8 * track_len)
    return xyz, rgb


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cams[int(parts[0])] = ColmapCamera(
                int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    """images.txt: two lines per image, the pose line and its 2D points.

    The points line may be empty (COLMAP writes it so for an image without
    points), so lines are paired before blank lines are dropped."""
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#")]
    images = {}
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if not parts:
            i += 1
            continue
        images[int(parts[0])] = ColmapImage(
            int(parts[0]), np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]), int(parts[8]), parts[9])
        i += 2
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
    return (np.array(xyz, np.float64).reshape(-1, 3),
            np.array(rgb, np.uint8).reshape(-1, 3))


def find_sparse_dir(source: str) -> str:
    for cand in [os.path.join(source, "sparse", "0"), os.path.join(source, "sparse"), source]:
        if (os.path.exists(os.path.join(cand, "cameras.bin"))
                or os.path.exists(os.path.join(cand, "cameras.txt"))):
            return cand
    raise FileNotFoundError(f"No COLMAP sparse model found under {source}")


def load_sparse(source: str):
    """(cameras, images, xyz, rgb) of a COLMAP dataset directory."""
    sparse = find_sparse_dir(source)
    if os.path.exists(os.path.join(sparse, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse, "images.bin"))
        xyz, rgb = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
        images = read_images_text(os.path.join(sparse, "images.txt"))
        xyz, rgb = read_points3d_text(os.path.join(sparse, "points3D.txt"))
    return cams, images, xyz, rgb


def colmap_init(gaussians, source: str, scene_extent: Optional[float] = None):
    """Initialise ``gaussians`` from the sparse points of the COLMAP dataset
    at ``source`` (``create_from_pcd``, on the model's device). The scene
    extent defaults to the radius of the image centres' bounding sphere
    times 1.1 (1.0 when they coincide)."""
    _, images, xyz, rgb = load_sparse(source)
    if scene_extent is None:
        centers = [-qvec2rotmat(img.qvec).T @ img.tvec for img in images.values()]
        centers = np.array(centers) if centers else np.zeros((1, 3))
        avg = centers.mean(0)
        scene_extent = float(np.linalg.norm(centers - avg, axis=1).max() * 1.1) or 1.0
    return gaussians.create_from_pcd(xyz.astype(np.float32), rgb.astype(np.float32) / 255.0,
                                     scene_extent=scene_extent)
