"""The port's native PLY and COLMAP I/O (models/native_io.py, its own copy
of the C++ source in models/csrc/ply_io.cpp) against numpy and the JAX
package's native library.

  * The library builds here with g++ into the build directory and reports
    itself active.
  * The port's native write gives numpy's bytes and the JAX package's
    native bytes; reading back gives the arrays, through the native path.
  * points3D.bin parses to the JAX package's arrays; a file that ends
    early is refused by the native parser and raises in the numpy one.
  * A model's save_ply/load_ply round trip goes through the native path.
"""
import os
import struct
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.dataset import colmap as tcolmap  # noqa: E402
from reduced_3dgs_torch.models import native_io  # noqa: E402
from reduced_3dgs_torch.models import ply as tply  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import _build  # noqa: E402
from reduced_3dgs_tpu.dataset import colmap as jcolmap  # noqa: E402
from reduced_3dgs_tpu.models import native_io as jnative  # noqa: E402

from .test_torch_fixtures import random_cloud_np, torch_model  # noqa: E402


def elements():
    rng = np.random.default_rng(0)
    vertex = tply.fields_to_struct(
        {"x": rng.normal(size=7).astype(np.float32), "c": (np.arange(7) % 3).astype(np.uint8),
         "d": rng.normal(size=7), "i": np.arange(7, dtype=np.int32) - 3,
         "s": np.arange(7, dtype=np.uint16)}, ["x", "c", "d", "i", "s"])
    book = tply.fields_to_struct({"v": np.linspace(0, 1, 4).astype(np.float32)}, ["v"])
    return OrderedDict(vertex=vertex, codebook=book)


def test_library_builds_with_gxx():
    assert native_io.active(), native_io.build_error()
    assert native_io.build_error() is None
    path = native_io.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libply_io_")


def test_native_write_matches_numpy_and_jax(tmp_path, monkeypatch):
    els = elements()
    ours, numpy_path, theirs = (str(tmp_path / n) for n in ("t.ply", "np.ply", "j.ply"))
    tply.write_ply(ours, els)
    assert native_io.last_path("write_ply") == "native"
    assert jnative.write_ply_native(theirs, els)
    with monkeypatch.context() as m:
        m.setattr(native_io, "get_lib", lambda: None)
        tply.write_ply(numpy_path, els)
        assert native_io.last_path("write_ply") == "numpy"
    data = open(ours, "rb").read()
    assert data == open(numpy_path, "rb").read() == open(theirs, "rb").read()
    with pytest.raises(ValueError, match="structured"):
        tply.write_ply(ours, OrderedDict(vertex=np.zeros(3)))


def test_read_round_trip(tmp_path, monkeypatch):
    els = elements()
    path = str(tmp_path / "e.ply")
    tply.write_ply(path, els)
    back = tply.read_ply(path)
    assert native_io.last_path("read_ply") == "native"
    with monkeypatch.context() as m:
        m.setattr(native_io, "get_lib", lambda: None)
        plain = tply.read_ply(path)
        assert native_io.last_path("read_ply") == "numpy"
    assert list(back) == list(els) == list(plain)
    for k in els:
        assert back[k].dtype == els[k].dtype == plain[k].dtype
        np.testing.assert_array_equal(back[k], els[k])
        np.testing.assert_array_equal(plain[k], els[k])
    # An ascii file is not the native reader's: it hands it to numpy.
    asc = str(tmp_path / "a.ply")
    with open(asc, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nend_header\n1\n2\n")
    assert native_io.read_ply_native(asc) is None
    np.testing.assert_array_equal(tply.read_ply(asc)["vertex"]["x"], [1, 2])
    assert native_io.last_path("read_ply") == "numpy"
    # A body shorter than the header says is refused, not allocated.
    short = str(tmp_path / "s.ply")
    with open(short, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 1000000000000\n"
                b"property float x\nend_header\n" + b"\0" * 8)
    assert native_io.read_ply_native(short) is None


def test_model_ply_round_trip_native(tmp_path):
    params, degrees = random_cloud_np(5, 30)
    model = torch_model(params, degrees)
    path = str(tmp_path / "m.ply")
    model.save_ply(path)
    assert native_io.last_path("write_ply") == "native"
    back = type(model)(3, device="cpu").load_ply(path)
    assert native_io.last_path("read_ply") == "native"
    for k, v in model.param_dict().items():
        assert torch.equal(back.param_dict()[k], v.detach()), k


def write_points(path, xyz, rgb, tracks):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *rgb[i], 0.5))
            f.write(struct.pack("<Q", tracks[i]))
            f.write(b"\x01" * (8 * tracks[i]))


def test_colmap_points_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(40, 3))
    rgb = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    path = str(tmp_path / "points3D.bin")
    write_points(path, xyz, rgb, rng.integers(0, 5, 40))
    t_xyz, t_rgb = tcolmap.read_points3d_binary(path)
    assert native_io.last_path("read_colmap_points") == "native"
    j_xyz, j_rgb = jcolmap.read_points3d_binary(path)
    np.testing.assert_array_equal(t_xyz, j_xyz)
    np.testing.assert_array_equal(t_rgb, j_rgb)
    np.testing.assert_array_equal(t_xyz, xyz)
    np.testing.assert_array_equal(t_rgb, rgb)
    assert t_xyz.dtype == np.float64 and t_rgb.dtype == np.uint8


@pytest.mark.parametrize("cut", [4, 60, -3])
def test_colmap_points_truncated(tmp_path, cut):
    """A points3D.bin that ends early (in the count, in a record, inside the
    last track) is refused by the native parser, and the numpy parser
    raises EOFError."""
    path = str(tmp_path / "points3D.bin")
    write_points(path, np.ones((3, 3)), np.ones((3, 3), np.uint8), [2, 2, 2])
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:cut])
    assert native_io.read_colmap_points_native(path) is None
    with pytest.raises(EOFError):
        tcolmap.read_points3d_binary(path)
    assert native_io.last_path("read_colmap_points") == "numpy"
