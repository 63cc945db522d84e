"""PyTorch port vs JAX package: the render CLI end to end, and the PLY
format both ways."""
import json
import math
import os
import shutil
import struct

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from .test_torch_fixtures import random_cloud_np, torch_model  # noqa: E402

H, W = 32, 48
FX = W / (2 * math.tan(math.radians(30)))
FY = H / (2 * math.tan(math.radians(21)))
# (qw, qx, qy, qz), (tx, ty, tz): small pose offsets around the origin.
POSES = [((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
         ((math.cos(0.05), 0.0, math.sin(0.05), 0.0), (0.1, 0.0, 0.1)),
         ((math.cos(-0.04), math.sin(-0.04), 0.0, 0.0), (-0.1, 0.05, 0.0))]


def _write_dataset(root, params):
    """COLMAP text model with 3 PINHOLE views and ground-truth PNGs, rendered
    by the port from a perturbed copy of the scene so PSNR is finite."""
    from PIL import Image
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.dataset.colmap import qvec2rotmat

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        f.write(f"1 PINHOLE {W} {H} {FX!r} {FY!r} {W / 2} {H / 2}\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(params["xyz"][:10]):
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.1\n")
    gt_params = dict(params)
    gt_params["xyz"] = params["xyz"] + np.float32(0.01)
    gt_model = torch_model(gt_params, None)
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for i, (q, t) in enumerate(POSES):
            name = f"view{i}.png"
            f.write(f"{i + 1} {' '.join(map(repr, q))} {' '.join(map(repr, t))} 1 {name}\n")
            f.write("10.0 12.0 -1\n")
            cam = build_camera(H, W, 2 * math.atan(W / (2 * FX)), 2 * math.atan(H / (2 * FY)),
                               R=qvec2rotmat(np.array(q)).T, T=np.array(t), device="cpu")
            with torch.no_grad():
                img = torch.clamp(gt_model(cam)["render"], 0, 1)
            arr = (img * 255).to(torch.uint8).numpy().transpose(1, 2, 0)
            Image.fromarray(arr).save(os.path.join(root, "images", name))


def test_render_cli_matches_jax(tmp_path):
    from reduced_3dgs_torch.render import main as tmain
    from reduced_3dgs_tpu.render import main as jmain

    params, _ = random_cloud_np(51, 60, spread=0.8)
    src = str(tmp_path / "src")
    _write_dataset(src, params)
    dst_t, dst_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    ply = os.path.join(dst_t, "point_cloud", "iteration_7", "point_cloud.ply")
    torch_model(params, None).save_ply(ply)
    shutil.copytree(os.path.join(dst_t, "point_cloud"), os.path.join(dst_j, "point_cloud"))

    tmain(["-s", src, "-d", dst_t, "-i", "7", "--device", "cpu"])
    jmain(["-s", src, "-d", dst_j, "-i", "7", "--no_save_images"])
    with open(os.path.join(dst_t, "metrics.json")) as f:
        t = json.load(f)["summary"]
    with open(os.path.join(dst_j, "metrics.json")) as f:
        j = json.load(f)["summary"]
    assert t["n_images"] == j["n_images"] == len(POSES)
    assert t["n_points"] == j["n_points"] == 60
    assert 15.0 < t["psnr"] < 60.0
    assert abs(t["psnr"] - j["psnr"]) < 1e-3
    assert abs(t["ssim"] - j["ssim"]) < 1e-5
    assert sorted(os.listdir(os.path.join(dst_t, "renders"))) == [
        f"{i:05d}.png" for i in range(len(POSES))]


def test_colmap_images_text_with_empty_points_line(tmp_path):
    """COLMAP writes an empty 2D-points line for an image without points;
    the pose lines that follow must still pair up. Checked against the
    poses written, not against the JAX reader, which drops blank lines
    before it pairs them."""
    from reduced_3dgs_torch.dataset.colmap import read_images_text
    poses = {1: ((1.0, 0.0, 0.0, 0.0), (0.5, 0.0, 0.0), 1, "a.png", ""),
             2: ((0.9, 0.1, 0.0, 0.0), (0.0, 0.25, 0.0), 2, "b.png", "1.0 2.0 -1"),
             3: ((0.8, 0.0, 0.2, 0.0), (0.0, 0.0, 1.5), 1, "c.png", ""),
             4: ((0.7, 0.0, 0.0, 0.3), (-1.0, 0.0, 0.0), 2, "d.png", "3.0 4.0 7")}
    lines = ["# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME"]
    for iid, (q, t, cam, name, points) in poses.items():
        lines += [f"{iid} {' '.join(map(str, q))} {' '.join(map(str, t))} {cam} {name}", points]
    path = tmp_path / "images.txt"
    path.write_text("\n".join(lines) + "\n")
    images = read_images_text(str(path))
    assert sorted(images) == sorted(poses)
    for iid, (q, t, cam, name, _) in poses.items():
        assert (images[iid].id, images[iid].camera_id, images[iid].name) == (iid, cam, name)
        np.testing.assert_array_equal(images[iid].qvec, q)
        np.testing.assert_array_equal(images[iid].tvec, t)


def _jax_arrays(model):
    return {k: np.asarray(v) for k, v in model.parameters().items()}


def test_ply_port_save_jax_load(tmp_path):
    from reduced_3dgs_tpu.models import GaussianModel as JaxModel
    params, _ = random_cloud_np(52, 30)
    path = str(tmp_path / "p.ply")
    torch_model(params, None).save_ply(path)
    loaded = _jax_arrays(JaxModel(3).load_ply(path))
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_ply_jax_save_port_load(tmp_path):
    import jax.numpy as jnp
    from reduced_3dgs_tpu.models import GaussianModel as JaxModel
    params, _ = random_cloud_np(53, 30)
    path = str(tmp_path / "p.ply")
    JaxModel(3).set_parameters({k: jnp.asarray(v) for k, v in params.items()}).save_ply(path)
    port = torch_model(params, None)
    port.load_ply(path)
    for k, v in port.param_dict().items():
        np.testing.assert_array_equal(v.detach().numpy(), params[k], err_msg=k)
    assert port._degrees.tolist() == [3] * 30


def test_cameras_json_from_jax_loads_in_port(tmp_path):
    """prepare_dataset(load_camera=...) reads the cameras.json the JAX
    package writes, into the same row-vector transforms."""
    from reduced_3dgs_torch.dataset import prepare_dataset
    from reduced_3dgs_tpu.dataset import CameraDataset, build_camera
    from reduced_3dgs_tpu.dataset.colmap import qvec2rotmat
    cams = [build_camera(H, W, 2 * math.atan(W / (2 * FX)), 2 * math.atan(H / (2 * FY)),
                         R=qvec2rotmat(np.array(q)).T, T=np.array(t)) for q, t in POSES]
    path = str(tmp_path / "cameras.json")
    CameraDataset(cams).save_cameras(path)
    port = prepare_dataset(source=str(tmp_path), device="cpu", load_camera=path)
    assert len(port) == len(cams)
    for j, t in zip(cams, port):
        assert (t.image_height, t.image_width) == (H, W)
        for k in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                       atol=1e-5, err_msg=k)


def _images_bin(path, names):
    """A COLMAP images.bin of ``names``, each with one 2D point."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, name in enumerate(names):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", 1.0, 0.0, 0.0, 0.0))
            f.write(struct.pack("<ddd", 0.1 * i, 0.0, 0.0))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1))
        return f.tell()


# Bytes cut from the end of a two-image file: inside the second image's
# point, its point count, its name, its pose.
@pytest.mark.parametrize("cut", [5, 24 + 3, 24 + 8 + 4, 24 + 8 + len("view1.png") + 4 + 20])
def test_colmap_images_binary_truncated_raises(tmp_path, cut):
    """The port's images.bin reader raises EOFError on a truncated file; it
    must not loop at an image name that the end of the file cuts off (the
    JAX reader's ``f.read(1)`` returns b"" there forever)."""
    from reduced_3dgs_torch.dataset.colmap import read_images_binary
    path = str(tmp_path / "images.bin")
    size = _images_bin(path, ["view0.png", "view1.png"])
    whole = read_images_binary(path)
    assert [im.name for im in whole.values()] == ["view0.png", "view1.png"]
    with open(path, "r+b") as f:
        f.truncate(size - cut)
    with pytest.raises(EOFError, match="bytes early"):
        read_images_binary(path)
