"""The port's LPIPS (metrics/lpips.py) against the JAX package's.

  * Without weights: unavailable, and a RuntimeError naming the path.
  * Seeded random weights in the exporter's .npz layout: the port's
    distance equals JAX's within rtol 1e-5 (one set carried by
    ``load_lpips_params``, one read from the file by each package), is 0
    for equal images and positive otherwise.
  * render.main reports a finite LPIPS per view when the weights are
    there, and no LPIPS when they are not.
"""
import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

from reduced_3dgs_torch import metrics  # noqa: E402
from reduced_3dgs_torch import render as trender  # noqa: E402

# The packages export the function ``lpips`` under the module's name.
tl = importlib.import_module("reduced_3dgs_torch.metrics.lpips")
jl = importlib.import_module("reduced_3dgs_tpu.metrics.lpips")


def synthetic_weights(seed):
    """Random weights with the exporter's keys and shapes, biases non-zero."""
    rng = np.random.default_rng(seed)
    params, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(tl._ALEX):
        params[f"conv{i}/w"] = rng.normal(0, 0.05, (out_ch, in_ch, k, k)).astype(np.float32)
        params[f"conv{i}/b"] = rng.normal(0, 0.01, (out_ch,)).astype(np.float32)
        params[f"lin{i}/w"] = rng.random(out_ch).astype(np.float32)
        in_ch = out_ch
    return params


@pytest.fixture
def weights(tmp_path, monkeypatch):
    path = tmp_path / "lpips_alex.npz"
    params = synthetic_weights(0)
    np.savez(path, **params)
    monkeypatch.setenv("R3DGS_LPIPS_WEIGHTS", str(path))
    jl._load_weights_np.cache_clear()
    yield params
    jl._load_weights_np.cache_clear()


def test_unavailable_without_weights(tmp_path, monkeypatch):
    missing = str(tmp_path / "missing.npz")
    monkeypatch.setenv("R3DGS_LPIPS_WEIGHTS", missing)
    assert tl.default_weights_path() == missing
    assert not metrics.lpips_available()
    with pytest.raises(RuntimeError, match="missing.npz"):
        metrics.lpips(torch.zeros((3, 32, 32)), torch.zeros((3, 32, 32)))
    monkeypatch.delenv("R3DGS_LPIPS_WEIGHTS")
    assert tl.default_weights_path().endswith(os.path.join("weights", "lpips_alex.npz"))


def test_matches_jax(weights):
    assert tl.lpips_available() and jl.lpips_available()
    rng = np.random.default_rng(1)
    a = rng.random((3, 64, 80)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = float(jl.lpips(a, b))
    got_file = float(tl.lpips(torch.from_numpy(a), torch.from_numpy(b)))
    carried = tl.load_lpips_params(weights)
    got_carried = float(tl.lpips(torch.from_numpy(a), torch.from_numpy(b), carried))
    assert want > 0
    assert got_file == pytest.approx(want, rel=1e-5)
    assert got_carried == got_file
    assert float(tl.lpips(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(0, abs=1e-7)
    assert all(v.dtype == torch.float32 for v in carried.values())


def test_render_cli_reports_lpips(tmp_path, monkeypatch):
    from .test_torch_pruning import write_colmap
    from reduced_3dgs_torch.dataset.colmap import colmap_init
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from PIL import Image
    src, dst = str(tmp_path / "scene"), str(tmp_path / "model")
    rng = np.random.default_rng(47)
    write_colmap(src, rng.normal(0.0, 0.6, (40, 3)) + np.array([0.0, 0.0, 4.0]),
                 rng.integers(0, 256, (40, 3)).astype(np.uint8), binary=True)
    # 64x48 views: AlexNet's strides and pools need more than 24x32.
    with open(os.path.join(src, "sparse", "0", "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, 64, 48) + struct.pack("<dddd", 60, 60, 32, 24))
    model = colmap_init(VariableSHGaussianModel(3, device="cpu"), src)
    os.makedirs(os.path.join(src, "images"))
    for i, cam in enumerate(prepare_dataset(src, device="cpu")):
        with torch.no_grad():
            img = torch.clamp(model(cam)["render"] + 0.2, 0, 1)
        Image.fromarray((img * 255).to(torch.uint8).numpy().transpose(1, 2, 0)).save(
            os.path.join(src, "images", f"v{i}.png"))
    model.save_ply(os.path.join(dst, "point_cloud", "iteration_1", "point_cloud.ply"))
    argv = ["-s", src, "-d", dst, "-i", "1", "--device", "cpu", "--no_save_images"]
    monkeypatch.setenv("R3DGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    trender.main(argv)
    with open(os.path.join(dst, "metrics.json")) as f:
        assert all("lpips" not in m for m in json.load(f)["per_image"])
    np.savez(tmp_path / "w.npz", **synthetic_weights(2))
    monkeypatch.setenv("R3DGS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    trender.main(argv)
    with open(os.path.join(dst, "metrics.json")) as f:
        got = json.load(f)
    per_image = got["per_image"]
    assert len(per_image) == 3
    assert all(np.isfinite(m["lpips"]) and m["lpips"] > 0 for m in per_image)
    assert got["summary"]["lpips"] == pytest.approx(np.mean([m["lpips"] for m in per_image]))
