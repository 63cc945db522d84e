"""PyTorch port vs JAX package: the optimizer, the trainers and the loop.

Five ``BaseTrainer`` steps of both packages start from the same parameters
on the toy scene of tests/test_trainer.py (40 Gaussians, three 32x32 views,
the JAX model on its XLA tiled path) and must give the same losses (rtol
1e-4), parameters and densification statistics (rtol 1e-3, atol 1e-6).
Adam's first steps move each entry by about lr sign(g), so an entry whose
gradient sits at noise level (|g| < 1e-7 max|g| at some step) may differ
by up to 2 k lr after k steps; that allowance holds for those entries
only, and the test bounds how many there are."""
import json
import math
import os
import random

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import CameraDataset as TCameraDataset  # noqa: E402
from reduced_3dgs_torch.models import GaussianModel as TGaussianModel  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer as TBaseTrainer  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer as TTrainer  # noqa: E402
from reduced_3dgs_torch.trainer.optimizer import adam_init as tadam_init  # noqa: E402
from reduced_3dgs_torch.trainer.optimizer import adam_update as tadam_update  # noqa: E402
from reduced_3dgs_torch.utils.schedule import get_expon_lr_func as tget_expon  # noqa: E402
from reduced_3dgs_tpu import train as jtrain  # noqa: E402
from reduced_3dgs_tpu.dataset import CameraDataset as JCameraDataset  # noqa: E402
from reduced_3dgs_tpu.dataset import build_camera as jbuild_camera  # noqa: E402
from reduced_3dgs_tpu.models import GaussianModel as JGaussianModel  # noqa: E402
from reduced_3dgs_tpu.trainer import BaseTrainer as JBaseTrainer  # noqa: E402
from reduced_3dgs_tpu.trainer.optimizer import adam_init as jadam_init  # noqa: E402
from reduced_3dgs_tpu.trainer.optimizer import adam_update as jadam_update  # noqa: E402
from reduced_3dgs_tpu.utils.schedule import get_expon_lr_func as jget_expon  # noqa: E402

from . import test_trainer as jt  # noqa: E402

STEPS = 5
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _port_scene(jds, jparams):
    """The port's model and dataset of the JAX toy scene."""
    cams = [tbuild_camera(c.image_height, c.image_width, float(c.FoVx), float(c.FoVy),
                          R=np.asarray(c.R), T=np.asarray(c.T),
                          ground_truth_image=np.asarray(c.ground_truth_image), device="cpu")
            for c in jds]
    model = TGaussianModel(3, device="cpu").load_numpy(jparams)
    return model, TCameraDataset(cams)


class _RecordingTrainer(TBaseTrainer):
    """Keeps each step's gradients, read just before Adam."""

    def optimizer_step(self, out, offset):
        self.recorded = getattr(self, "recorded", [])
        self.recorded.append({k: p.grad.clone() for k, p in self.model.param_dict().items()})
        super().optimizer_step(out, offset)


@pytest.fixture(scope="module")
def five_steps():
    gt_model, jds = jt._toy_scene()
    jmodel = jt._perturbed_model(gt_model)
    jparams = {k: np.asarray(v) for k, v in jmodel.parameters().items()}
    n = jmodel.num_points
    jtr = JBaseTrainer(jmodel, jds)
    j_losses = [float(jtr.step(jds[it % len(jds)])[0]) for it in range(STEPS)]
    jp = {k: np.asarray(v)[:n] for k, v in jmodel.parameters().items()}
    j_acc = (np.asarray(jtr.xyz_grad_accum)[:n], np.asarray(jtr.xyz_grad_denom)[:n],
             np.asarray(jtr.max_radii2d)[:n])

    tmodel, tds = _port_scene(jds, jparams)
    ttr = _RecordingTrainer(tmodel, tds)
    t_losses = [float(ttr.step(tds[it % len(tds)])[0]) for it in range(STEPS)]
    tp = {k: v.detach().numpy() for k, v in tmodel.param_dict().items()}
    t_acc = (ttr.xyz_grad_accum.numpy(), ttr.xyz_grad_denom.numpy(), ttr.max_radii2d.numpy())
    return dict(j_losses=j_losses, t_losses=t_losses, jp=jp, tp=tp, j_acc=j_acc, t_acc=t_acc,
                trainer=ttr, jtrainer=jtr)


def test_five_base_trainer_steps_losses_match_jax(five_steps):
    np.testing.assert_allclose(five_steps["t_losses"], five_steps["j_losses"], rtol=1e-4)
    assert five_steps["t_losses"][-1] < five_steps["t_losses"][0] * 1.05
    assert five_steps["trainer"].curr_step == STEPS


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_five_base_trainer_steps_parameters_match_jax(five_steps, name):
    tr = five_steps["trainer"]
    lr = tr.lr_tree(dict.fromkeys(PARAM_NAMES))[name]
    t, j = five_steps["tp"][name], five_steps["jp"][name]
    noise = np.zeros(t.shape, bool)
    for grads in tr.recorded:
        g = grads[name].numpy()
        noise |= np.abs(g) < 1e-7 * np.abs(g).max()
    close = np.abs(t - j) <= 1e-6 + 1e-3 * np.abs(j)
    excused = ~close & noise & (np.abs(t - j) <= 2 * STEPS * lr * (1 + 1e-3))
    assert (close | excused).all(), (name, np.abs(t - j)[~(close | excused)])
    # Only entries whose gradient is noise may take the allowance, and few
    # do (none on this scene when it was written; 35 of the 1800
    # features_rest entries have a noise-level gradient).
    assert excused.sum() <= max(3, 0.01 * t.size), (name, excused.sum())


def test_five_base_trainer_steps_statistics_match_jax(five_steps):
    (t_accum, t_denom, t_radii), (j_accum, j_denom, j_radii) = (five_steps["t_acc"],
                                                                five_steps["j_acc"])
    assert t_denom.max() == STEPS and t_radii.max() > 0
    np.testing.assert_allclose(t_accum, j_accum, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(t_denom, j_denom)
    np.testing.assert_allclose(t_radii, j_radii, rtol=1e-3, atol=1e-6)
    five_steps["trainer"].reset_densification_stats()
    assert not five_steps["trainer"].xyz_grad_accum.any()


def test_adam_update_matches_jax():
    rng = np.random.default_rng(81)
    params = {"a": rng.normal(size=(6, 3)).astype(np.float32),
              "b": rng.normal(size=(6, 1, 3)).astype(np.float32)}
    lrs = {"a": 0.01, "b": 0.003}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tstate = tadam_init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadam_init(jp)
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        grads["a"][0] = 0.0  # a zero gradient leaves the entry in place
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        tadam_update(tp, tstate, lrs)
        jp, jstate = jadam_update(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, lrs)
    assert tstate.count == int(jstate.count) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]), rtol=1e-6)
    np.testing.assert_array_equal(tp["a"].detach().numpy()[0], params["a"][0])


@pytest.mark.parametrize("delay_steps", [0, 100])
def test_expon_lr_schedule_matches_jax(delay_steps):
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=delay_steps,
              lr_delay_mult=0.01, max_steps=3000)
    t, j = tget_expon(**kw), jget_expon(**kw)
    for step in (0, 1, 50, 100, 1500, 3000, 5000):
        assert t(step) == pytest.approx(j(step), rel=1e-12)
    assert tget_expon(0.0, 0.0)(10) == 0.0


def test_trainer_lr_schedule_and_sh_warmup():
    """As tests/test_trainer.py for the JAX Trainer: the xyz rate follows
    the log-lerp schedule of the current step, and one SH band is added
    every sh_degree_up_interval steps."""
    gt_model, jds = jt._toy_scene(n=10)
    jparams = {k: np.asarray(v) for k, v in jt._perturbed_model(gt_model).parameters().items()}
    model, ds = _port_scene(jds, jparams)
    trainer = TTrainer(model, ds, sh_degree_up_interval=5, position_lr_max_steps=20)
    sched = jget_expon(1.6e-4 * trainer.spatial_lr_scale, 1.6e-6 * trainer.spatial_lr_scale,
                       lr_delay_mult=0.01, max_steps=20)
    assert model.active_sh_degree == 0
    lr0 = trainer.xyz_lr()
    degrees = []
    for it in range(12):
        assert trainer.xyz_lr() == pytest.approx(sched(it), rel=1e-12)
        trainer.step(ds[it % len(ds)])
        degrees.append(model.active_sh_degree)
    assert degrees == [0] * 5 + [1] * 5 + [2] * 2
    assert model.active_sh_degree == 2
    assert trainer.xyz_lr() < lr0


def test_scene_extent_and_cameras_json_match_jax(tmp_path):
    rng = np.random.default_rng(82)
    jcams, tcams = [], []
    for i in range(3):
        ang = 0.2 * i
        R = np.array([[math.cos(ang), 0, -math.sin(ang)], [0, 1, 0],
                      [math.sin(ang), 0, math.cos(ang)]], np.float32)
        T = rng.normal(size=3).astype(np.float32)
        jcams.append(jbuild_camera(image_height=24, image_width=40, FoVx=1.1, FoVy=0.7,
                                     R=R, T=T))
        tcams.append(tbuild_camera(24, 40, 1.1, 0.7, R=R, T=T, device="cpu"))
    jds, tds = JCameraDataset(jcams), TCameraDataset(tcams)
    assert tds.scene_extent() == pytest.approx(jds.scene_extent(), rel=1e-6)
    tds.save_cameras(str(tmp_path / "t" / "cameras.json"))
    jds.save_cameras(str(tmp_path / "j" / "cameras.json"))
    with open(tmp_path / "t" / "cameras.json") as f:
        t_entries = json.load(f)
    with open(tmp_path / "j" / "cameras.json") as f:
        j_entries = json.load(f)
    assert len(t_entries) == 3
    for te, je in zip(t_entries, j_entries):
        assert te["img_name"] == je["img_name"] and te["width"] == je["width"]
        for key in ("position", "rotation", "fx", "fy"):
            np.testing.assert_allclose(te[key], je[key], rtol=1e-5, atol=1e-6, err_msg=key)
    back = JCameraDataset.load_cameras(str(tmp_path / "t" / "cameras.json"))
    np.testing.assert_allclose(np.asarray(back[1].R), np.asarray(jcams[1].R), atol=1e-5)
    np.testing.assert_allclose(np.asarray(back[1].T), np.asarray(jcams[1].T), atol=1e-5)


def test_save_cfg_args_matches_jax(tmp_path):
    ttrain.save_cfg_args(str(tmp_path / "t"), 3, "/data/scene")
    jtrain.save_cfg_args(str(tmp_path / "t2"), 3, "/data/scene")
    t = (tmp_path / "t" / "cfg_args").read_text()
    j = (tmp_path / "t2" / "cfg_args").read_text()
    assert t == j.replace(str(tmp_path / "t2"), str(tmp_path / "t"))


def test_training_loop_reduces_loss_and_saves(tmp_path, capsys):
    """training() on the CPU: the loss falls on the toy scene, the PLY and
    cameras.json are written at the save iterations and at the end, and the
    JAX package reads the PLY back."""
    gt_model, jds = jt._toy_scene()
    jparams = {k: np.asarray(v) for k, v in jt._perturbed_model(gt_model).parameters().items()}
    model, ds = _port_scene(jds, jparams)
    trainer = TBaseTrainer(model, ds)
    losses = ttrain.training(ds, model, trainer, None, str(tmp_path), iteration=60,
                             save_iterations=[30], device="cpu", log_interval=20,
                             generator=random.Random(3))
    values = [float(v) for v in losses]
    assert len(values) == 60 and all(map(math.isfinite, values))
    assert np.mean(values[-6:]) < 0.6 * np.mean(values[:6]), values
    assert trainer.curr_step == 60
    printed = capsys.readouterr().out
    assert printed.count("Training ") == 3 and "60/60" in printed
    for it in (30, 60):
        assert os.path.exists(tmp_path / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")
    assert os.path.exists(tmp_path / "cameras.json")
    jm = JGaussianModel(3)
    jm.load_ply(str(tmp_path / "point_cloud" / "iteration_60" / "point_cloud.ply"))
    assert jm.num_points == model.num_points
    for name, p in model.param_dict().items():
        np.testing.assert_array_equal(np.asarray(jm.parameters()[name]), p.detach().numpy(),
                                      err_msg=name)
