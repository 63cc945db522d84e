"""The port's mode registry and command-line entry points (prepare.py,
train.main, quantize.main, render.main --load_quantized).

  * Each of the ten modes, with and without ``quantize`` and
    ``with_scale_reg``, builds the JAX package's onion of wrappers, layer by
    layer; a camera mode's model class is the camera-trainable one and the
    gsplat-2dgs backend takes the 2DGS (surfel) classes. ``--mesh`` raises
    where the mesh does not fit the world of processes (a single process
    here; tests/test_torch_sharded.py runs it over several).
  * ``train.main --device cpu`` on a tiny COLMAP dataset (3 views of 24x32,
    60 sparse points) writes cfg_args, cameras.json and both PLYs, with
    ``-o`` values parsed as literals; ``quantize.main`` and
    ``render.main --load_quantized`` run on its output, and the quantized
    model renders as the dequantized PLY it wrote. Without ``--device cpu``
    every entry point raises here.
  * ``train.main --mode camera-densify-pruning-shculling`` on the same
    dataset learns each view's pose and writes it to cameras.json;
    ``render.main --load_camera`` of it scores as the renders from the
    trainer's adjusted cameras do.
  * ``prepare_dataset(load_camera=...)`` takes the source's images by name
    at the resolution scale, raises on an image whose size is not its
    view's and warns of views without an image.
  * ``train.main --backend gsplat-2dgs`` runs the flagship and a camera
    mode on the same dataset against the JAX package's trainer of the same
    mode and backend, stepped over the same views: N after every step and
    every removal mask exact and the losses within rtol 1e-4 (the flagship
    toy run's bars), after a margin on every decision; the flagship's state
    within the 2DGS gradient bars (below).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch import models as tmodels  # noqa: E402
from reduced_3dgs_torch import prepare as tprepare  # noqa: E402
from reduced_3dgs_torch import quantize as tquantize  # noqa: E402
from reduced_3dgs_torch import render as trender  # noqa: E402
from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.dataset.colmap import colmap_init  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import prepare_dataset  # noqa: E402
from reduced_3dgs_torch.models.ply import read_ply  # noqa: E402
from reduced_3dgs_torch.shculling import \
    CameraTrainableVariableSHGaussianModel as CameraTModel  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_torch.shculling import \
    CameraTrainableVariableSHGsplat2DGSGaussianModel as CameraTModel2DGS  # noqa: E402
from reduced_3dgs_torch.shculling import \
    VariableSHGsplat2DGSGaussianModel as TModel2DGS  # noqa: E402
from reduced_3dgs_torch.utils.math import psnr  # noqa: E402
from reduced_3dgs_tpu import prepare as jprepare  # noqa: E402

from .test_torch_fixtures import (jax_dataset, jax_model, random_cloud_np,  # noqa: E402
                                  torch_dataset, torch_model)
from .test_torch_densification import _jax_live  # noqa: E402
from .test_torch_pruning import (RUN_CONFIG, check_decision_margins,  # noqa: E402
                                 check_masks_and_row_counts, jax_half, onion, torch_half,
                                 write_colmap)

MODES = ["densify-shculling", "pruning", "pruning-shculling", "densify-pruning",
         "densify-pruning-shculling", "camera-densify-shculling", "camera-pruning",
         "camera-pruning-shculling", "camera-densify-pruning",
         "camera-densify-pruning-shculling"]
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


def test_modes_and_backends_match_jax(tmp_path):
    """The ten modes in the JAX package's order; each camera mode is the
    CameraTrainer over its mode without the prefix, with or without
    ``quantize``; ``trainable_camera`` picks the camera-trainable class, and
    the gsplat-2dgs backend picks the 2DGS classes, as JAX's registry
    does."""
    assert list(tprepare.modes) == list(jprepare.modes)
    params, degrees = random_cloud_np(45, 8)
    ds = torch_dataset([dict(height=16, width=16, fovx=1.0, fovy=1.0,
                             R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
                             bg=np.zeros(3, np.float32))])
    for mode in tprepare.modes:
        if mode.startswith("camera-"):
            for quantize in (False, True):
                t, _ = tprepare.prepare_trainer(torch_model(params, degrees), ds, mode,
                                                quantize=quantize)
                base, _ = tprepare.prepare_trainer(torch_model(params, degrees), ds,
                                                   mode[len("camera-"):], quantize=quantize)
                assert onion(t) == onion(base)[:quantize] + ["CameraTrainer"] \
                    + onion(base)[quantize:]
    assert tprepare.get_gaussian_model_class("gsplat-2dgs") is TModel2DGS
    assert tprepare.get_gaussian_model_class("gsplat-2dgs", trainable_camera=True) \
        is CameraTModel2DGS
    for trainable_camera in (False, True):
        assert tprepare.get_gaussian_model_class("gsplat-2dgs", trainable_camera).__name__ == \
            jprepare.get_gaussian_model_class("gsplat-2dgs", trainable_camera).__name__
    for backend in ("cuda", "inria", "gsplat"):
        assert tprepare.get_gaussian_model_class(backend) is TModel
        assert tprepare.get_gaussian_model_class(backend, trainable_camera=True) \
            is CameraTModel
    assert issubclass(CameraTModel, TModel)
    assert issubclass(CameraTModel, tmodels.CameraTrainableGaussianModel)
    ply = str(tmp_path / "p.ply")
    torch_model(params, degrees).save_ply(ply)
    model = tprepare.prepare_gaussians(3, "", device="cpu", trainable_camera=True, load_ply=ply)
    assert type(model) is CameraTModel and model.num_points == 8
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


def test_camera_mode_main_and_render_load_camera(scene, tmp_path, monkeypatch):
    """train.main in the camera flagship mode writes each view's learned
    pose to cameras.json; render.main --load_camera of it (images taken from
    the source by name) scores each view as the trained model renders from
    the trainer's adjusted camera."""
    src = scene[0]
    out = str(tmp_path / "camera")
    runs = []
    training = ttrain.training

    def keep(**kwargs):
        runs.append(kwargs)
        return training(**kwargs)

    monkeypatch.setattr(ttrain, "training", keep)
    losses = ttrain.main(["-s", src, "-d", out, "-i", str(STEPS), "--device", "cpu",
                          "--mode", "camera-densify-pruning-shculling"])
    assert len(losses) == STEPS and all(np.isfinite(float(v)) for v in losses)
    (run,) = runs
    trainer, dataset = run["trainer"], run["dataset"]
    assert type(trainer).__name__ == "CameraTrainer" and type(run["gaussians"]) is CameraTModel
    assert type(dataset).__name__ == "TrainableCameraDataset"
    # One slot per view: the dataset hands out its stored cameras, sliced too.
    assert len(trainer._cam_params) == len(dataset) == 3
    assert type(dataset[0:2]) is type(dataset) and dataset[0:2].cameras[1] is dataset[1]
    trender.main(["-s", src, "-d", out, "-i", str(STEPS), "--device", "cpu",
                  "--no_save_images", "--load_camera", os.path.join(out, "cameras.json")])
    with open(os.path.join(out, "metrics.json")) as f:
        got = [m["psnr"] for m in json.load(f)["per_image"]]
    model = TModel(3, device="cpu").load_ply(
        os.path.join(out, "point_cloud", f"iteration_{STEPS}", "point_cloud.ply"))
    want = []
    with torch.no_grad():
        for cam in dataset:
            adjusted = trainer.adjusted_camera(cam)
            assert float((adjusted.world_view_transform - cam.world_view_transform)
                         .abs().max()) > 1e-6
            want.append(float(psnr(model(adjusted)["render"], cam.ground_truth_image).mean()))
    assert got == pytest.approx(want, rel=1e-6)



@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_load_camera_images_by_name(scene, tmp_path, scale):
    """prepare_dataset(load_camera=...) takes each view's image from the
    source by name at the resolution scale: a cameras.json of the views at
    that scale gets the images of the COLMAP load at that scale; the same
    file at the other scale raises, naming the image; a view whose image is
    missing keeps no image, with a warning that names it."""
    import shutil
    src = scene[0]
    direct = prepare_dataset(src, device="cpu", resolution_scale=scale)
    path = str(tmp_path / "cameras.json")
    direct.save_cameras(path)
    loaded = prepare_dataset(src, device="cpu", load_camera=path, resolution_scale=scale)
    assert loaded.image_names == direct.image_names == ["v0", "v1", "v2"]
    for a, b in zip(loaded, direct):
        assert a.ground_truth_image.shape[1:] == (a.image_height, a.image_width)
        assert torch.equal(a.ground_truth_image, b.ground_truth_image)
    with pytest.raises(ValueError, match="v0.png"):
        prepare_dataset(src, device="cpu", load_camera=path, resolution_scale=1.5 - scale)
    partial = str(tmp_path / "partial")
    shutil.copytree(src, partial)
    os.remove(os.path.join(partial, "images", "v1.png"))
    with pytest.warns(UserWarning, match=r"\['v1'\]"):
        got = prepare_dataset(partial, device="cpu", load_camera=path, resolution_scale=scale)
    assert got[1].ground_truth_image is None
    assert torch.equal(got[2].ground_truth_image, direct[2].ground_truth_image)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ttrain.main, tquantize.main, trender.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["-s", str(tmp_path), "-d", str(tmp_path)])


def test_train_main_mesh_raises(tmp_path, monkeypatch):
    """A 1x2 mesh needs two processes; without a launcher's WORLD_SIZE the
    world is this one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
        ttrain.main(["-s", str(tmp_path), "-d", str(tmp_path), "--device", "cpu",
                     "--mesh", "1x2"])


# ------------------------------------------------- the 2DGS backend end to end
TWODGS_STEPS = 12
# The flagship toy run's schedule: split 3, opacity + mercy prune 5,
# importance prune 7, SH cull 9, reset 10.
TWODGS_CONFIG = dict(RUN_CONFIG)


def surfel_start(path, seed=52, n=60):
    """A PLY of n random anisotropic, randomly rotated Gaussians in front of
    the scene's views. (From the COLMAP start, isotropic scales and identity
    rotations leave a surfel's turn about its normal without gradient, so
    each package's Adam steps it by the sign of its own rounding.)"""
    params, _ = random_cloud_np(seed, n, spread=0.6, z_center=4.0, scale_lo=-3.0, scale_hi=-1.8)
    params["rotation"] = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    TModel(3, device="cpu").load_numpy(params).save_ply(path)
    return path


def main_vs_jax(src, out, mode, monkeypatch, load_ply, steps=TWODGS_STEPS,
                config=TWODGS_CONFIG):
    """``train.main --backend gsplat-2dgs --mode <mode> --device cpu -l
    <load_ply>`` with ``config`` as -o options, against the JAX package's
    trainer of that mode and backend from the same dataset and PLY, stepped
    over the views that ``training``'s shuffle (random.Random(0)) picks; the
    port's split is fed the JAX draw. Returns the two halves' records
    (tests/test_torch_pruning)."""
    import random
    from reduced_3dgs_tpu import train as jtrain
    n_views = len(prepare_dataset(src, device="cpu"))
    rng, order, views = random.Random(0), list(range(n_views)), []
    for step in range(steps):
        if step % n_views == 0:
            rng.shuffle(order)
        views.append(order[step % n_views])
    jds, jm, jtr, _ = jtrain.prepare_training(
        sh_degree=3, source=src, device="cpu", mode=mode,
        trainable_camera=mode.startswith("camera-"), load_ply=load_ply, backend="gsplat-2dgs",
        configs=dict(config))
    j = jax_half(jtr, jm, jds, views)
    training, halves = ttrain.training, []

    def run(**kwargs):
        losses = []

        def drive(step):
            kwargs["trainer"].step = step
            losses.extend(training(**kwargs))

        halves.append(torch_half(kwargs["trainer"], kwargs["gaussians"], kwargs["dataset"],
                                 j["capacity"], drive))
        halves[-1].update(gaussians=kwargs["gaussians"], dataset=kwargs["dataset"])
        return losses

    monkeypatch.setattr(ttrain, "training", run)
    argv = ["-s", src, "-d", out, "-i", str(steps), "--device", "cpu", "--backend",
            "gsplat-2dgs", "--mode", mode, "-l", load_ply]
    for k, v in config.items():
        argv += ["-o", f"{k}={v!r}"]
    losses = ttrain.main(argv)
    (t,) = halves
    assert [float(v) for v in losses] == t["t_losses"]
    return dict(j, **t)


def check_2dgs_losses_and_state(run):
    """Losses within rtol 1e-4. The state after 12 steps within the 2DGS
    renderer's gradient bars, rtol 2e-3 / atol 3e-5 of max|v|: Adam turns
    the float32 differences of autograd and XLA's autodiff through the
    surfel renderer into these. ``max_radii2d`` within 1 px: a surfel
    smaller than the low-pass pad has the pad's integer half-extent, whose
    ceil each package takes of its own rounding."""
    np.testing.assert_allclose(run["t_losses"], run["j_losses"], rtol=1e-4)
    _, j = _jax_live(run["jtr"])
    t = run["ttr"].engine.state_trees()
    for group in ("params", "adam_m", "adam_v", "accum"):
        for name, v in t[group].items():
            jv = j[group][name]
            assert v.shape == jv.shape, (group, name)
            if name == "max_radii2d":
                np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1)
                continue
            np.testing.assert_allclose(v.numpy(), jv, rtol=2e-3, atol=3e-5 * np.abs(jv).max(),
                                       err_msg=f"{group}/{name}")


def test_2dgs_flagship_main_matches_jax(scene, tmp_path, monkeypatch):
    run = main_vs_jax(scene[0], str(tmp_path / "2dgs"), "densify-pruning-shculling", monkeypatch,
                      surfel_start(str(tmp_path / "start.ply")))
    assert type(run["gaussians"]) is TModel2DGS
    check_decision_margins(run)
    check_masks_and_row_counts(run)
    check_2dgs_losses_and_state(run)
    # The split adds, the opacity/mercy and importance prunes remove, the
    # cull lowers degrees.
    assert sorted(run["rec"]["masks"]) == [3, 5, 7]
    n = run["t_n"]                                 # N after steps 1, 2, ...
    assert n[1] < n[2] and n[4] < n[3] and n[6] < n[5]
    assert (run["t_deg"][9] < run["t_deg"][8][:len(run["t_deg"][9])]).any()
    saved = TModel2DGS(3, device="cpu").load_ply(
        os.path.join(str(tmp_path / "2dgs"), "point_cloud", f"iteration_{TWODGS_STEPS}",
                     "point_cloud.ply"))
    assert saved.num_points == run["t_n"][-1]


def test_2dgs_camera_mode_main_matches_jax(scene, tmp_path, monkeypatch):
    run = main_vs_jax(scene[0], str(tmp_path / "2dgs_camera"),
                      "camera-densify-pruning-shculling", monkeypatch,
                      surfel_start(str(tmp_path / "start.ply"), seed=50))
    assert type(run["gaussians"]) is CameraTModel2DGS
    assert type(run["ttr"]).__name__ == "CameraTrainer"
    assert len(run["ttr"]._cam_params) == 3
    check_decision_margins(run)
    check_masks_and_row_counts(run)
    np.testing.assert_allclose(run["t_losses"], run["j_losses"], rtol=1e-4)
    for cam in run["dataset"]:
        delta = run["ttr"]._cam_params[id(cam)]["trans"].detach()
        assert float(delta.abs().max()) > 0
