"""The port's mode registry and command-line entry points (prepare.py,
train.main, quantize.main, render.main --load_quantized).

  * Each of the five modes, with and without ``quantize`` and
    ``with_scale_reg``, builds the JAX package's onion of wrappers, layer by
    layer; the five camera modes and the gsplat-2dgs backend raise.
  * ``train.main --device cpu`` on a tiny COLMAP dataset (3 views of 24x32,
    60 sparse points) writes cfg_args, cameras.json and both PLYs, with
    ``-o`` values parsed as literals; ``quantize.main`` and
    ``render.main --load_quantized`` run on its output, and the quantized
    model renders as the dequantized PLY it wrote. Without ``--device cpu``
    every entry point raises here.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch import prepare as tprepare  # noqa: E402
from reduced_3dgs_torch import quantize as tquantize  # noqa: E402
from reduced_3dgs_torch import render as trender  # noqa: E402
from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.dataset.colmap import colmap_init  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import prepare_dataset  # noqa: E402
from reduced_3dgs_torch.models.ply import read_ply  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_tpu import prepare as jprepare  # noqa: E402

from .test_torch_fixtures import (jax_dataset, jax_model, random_cloud_np,  # noqa: E402
                                  torch_dataset, torch_model)
from .test_torch_pruning import onion, write_colmap  # noqa: E402

MODES = ["densify-shculling", "pruning", "pruning-shculling", "densify-pruning",
         "densify-pruning-shculling"]
STEPS = 6


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantize"])
@pytest.mark.parametrize("with_scale_reg", [False, True], ids=["", "scale_reg"])
def test_mode_onion_matches_jax(mode, quantize, with_scale_reg):
    params, degrees = random_cloud_np(44, 8)
    cams = [dict(height=16, width=16, fovx=1.0, fovy=1.0, R=np.eye(3, dtype=np.float32),
                 T=np.array([float(i), 0, 0], np.float32), bg=np.zeros(3, np.float32))
            for i in range(2)]
    kw = dict(mode=mode, with_scale_reg=with_scale_reg, quantize=quantize,
              configs={"num_clusters": 16})
    t, tquant = tprepare.prepare_trainer(torch_model(params, degrees), torch_dataset(cams), **kw)
    j, jquant = jprepare.prepare_trainer(jax_model(params, degrees), jax_dataset(cams), **kw)
    assert onion(t) == onion(j)
    assert type(tquant).__name__ == type(jquant).__name__
    if quantize:
        assert t.quantizer is tquant and tquant.num_clusters_scaling == 16
        assert (t.quantize_from_iter, t.quantize_until_iter, t.quantize_interval) == \
            (5000, 30000, 1000)


def test_modes_and_backends_match_jax_and_camera_modes_raise():
    assert list(tprepare.modes) == list(jprepare.modes)
    params, degrees = random_cloud_np(45, 8)
    ds = torch_dataset([dict(height=16, width=16, fovx=1.0, fovy=1.0,
                             R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
                             bg=np.zeros(3, np.float32))])
    for mode in tprepare.modes:
        if mode.startswith("camera-"):
            for quantize in (False, True):
                with pytest.raises(NotImplementedError, match="item 22"):
                    tprepare.prepare_trainer(torch_model(params, degrees), ds, mode,
                                             quantize=quantize)
    with pytest.raises(NotImplementedError, match="item 22"):
        tprepare.get_gaussian_model_class("gsplat-2dgs")
    with pytest.raises(NotImplementedError, match="item 22"):
        tprepare.get_gaussian_model_class("cuda", trainable_camera=True)
    for backend in ("cuda", "inria", "gsplat"):
        assert tprepare.get_gaussian_model_class(backend) is TModel
    with pytest.raises(ValueError, match="Unknown backend"):
        tprepare.get_gaussian_model_class("tpu")


def test_parse_options_reads_literals():
    configs = ttrain.parse_options(["a=1", "b=0.5", "c=[3, 4]", "d=name", "e=x=y", "f=True",
                                   "g=(1,)"])
    assert configs == {"a": 1, "b": 0.5, "c": [3, 4], "d": "name", "e": "x=y", "f": True,
                       "g": (1,)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A COLMAP text dataset with images rendered from its own COLMAP
    start, and a train.main run on it: (source, output)."""
    root = tmp_path_factory.mktemp("cli")
    src, out = str(root / "scene"), str(root / "out")
    rng = np.random.default_rng(46)
    xyz = rng.normal(0.0, 0.6, (60, 3)) + np.array([0.0, 0.0, 4.0])
    write_colmap(src, xyz, rng.integers(0, 256, (60, 3)).astype(np.uint8), binary=False)
    model = colmap_init(TModel(3, device="cpu"), src)
    from PIL import Image
    os.makedirs(os.path.join(src, "images"))
    for i, cam in enumerate(prepare_dataset(src, device="cpu")):
        with torch.no_grad():
            img = torch.clamp(model(cam)["render"] + 0.1, 0, 1)
        Image.fromarray((img * 255).to(torch.uint8).numpy().transpose(1, 2, 0)).save(
            os.path.join(src, "images", f"v{i}.png"))
    losses = ttrain.main(["-s", src, "-d", out, "-i", str(STEPS), "--device", "cpu",
                          "--quantize", "--with_scale_reg", "--save_iterations", "3",
                          "-o", "num_clusters=8", "-o", "quantize_from_iter=2",
                          "-o", "quantize_interval=2", "-o", "sh_degree_up_interval=2"])
    return src, out, losses


def test_train_main_writes_the_outputs(scene):
    src, out, losses = scene
    assert len(losses) == STEPS and all(np.isfinite(float(v)) for v in losses)
    assert os.path.exists(os.path.join(out, "cfg_args"))
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)) == 3
    for it in (3, STEPS):
        d = os.path.join(out, "point_cloud", f"iteration_{it}")
        raw = TModel(3, device="cpu").load_ply(os.path.join(d, "point_cloud.ply"))
        assert raw.num_points == 60
        elements = read_ply(os.path.join(d, "point_cloud_quantized.ply"))
        assert len(elements["vertex"]) == 60
        # -o num_clusters=8 reached the quantizer, parsed as an int.
        assert all(len(elements[k]) <= 8 for k in elements if k.startswith("codebook_"))
        assert len(elements["codebook_opacity"]) == 8


def test_quantize_and_render_load_quantized(scene, tmp_path):
    """quantize.main on the trained model; render.main --load_quantized of
    its quantized PLY and render.main of the dequantized PLY beside it give
    the same metrics."""
    src, out, _ = scene
    dst = str(tmp_path / "q")
    tquantize.main(["-s", out, "-d", dst, "-i", str(STEPS), "--device", "cpu",
                    "-o", "num_clusters=4", "-o", "max_iter=20"])
    it_dir = os.path.join(dst, "point_cloud", f"iteration_{STEPS}")
    assert os.path.exists(os.path.join(dst, "cfg_args"))
    assert os.path.exists(os.path.join(dst, "cameras.json"))
    assert len(read_ply(os.path.join(it_dir, "point_cloud_quantized.ply"))["codebook_scaling"]) \
        == 4
    metrics = {}
    for flags in ([], ["--load_quantized"]):
        trender.main(["-s", src, "-d", dst, "-i", str(STEPS), "--device", "cpu",
                      "--no_save_images", *flags])
        with open(os.path.join(dst, "metrics.json")) as f:
            metrics[bool(flags)] = json.load(f)
    assert metrics[True]["summary"]["n_points"] == 60
    assert metrics[True]["per_image"] == metrics[False]["per_image"]


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ttrain.main, tquantize.main, trender.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["-s", str(tmp_path), "-d", str(tmp_path)])


def test_train_main_mesh_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 22"):
        ttrain.main(["-s", str(tmp_path), "-d", str(tmp_path), "--device", "cpu",
                     "--mesh", "1x2"])
