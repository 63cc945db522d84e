"""PyTorch port vs JAX package: trainable cameras (the ``camera-*`` modes).

  * ``_apply_camera_delta`` on random deltas: matrices and centre within
    1e-6 of the JAX function's (which recovers the projection by an LU
    solve where the port keeps the camera's own); a zero delta gives back
    the camera bit for bit.
  * One step's camera gradient (``gcam``, the 7 delta components) at a
    delta carried across from the JAX trainer's slots
    (``CameraTrainer.load_numpy``): within the JAX package's gradient bars,
    rtol 2e-3 and atol 3e-5 of max|g|. A central difference (step 1e-3) of
    the port's own loss in ``trans`` agrees with its gradient within 5e-3
    of max|g_trans| (9.5e-4 on the CPU: the difference's own truncation).
  * ``CameraSHCullingOpacityResetFullReducedDensificationTrainer`` (the
    ``camera-densify-pruning-shculling`` mode) on the toy run of
    tests/test_torch_pruning.py (80 Gaussians, three 40x56 views, 12 steps:
    split, prune with mercy, importance prune, cull, opacity reset): the
    decisions' margins, N, masks and degrees exact, losses at rtol 1e-4,
    state at rtol 1e-3, and each view's normalised rotation and ``trans``
    within 1e-6 (the deltas are ~1e-4), after a margin on every step's camera gradient components
    but the rotation's w (|g| > 1e-4 max|g|). The quaternion's w gradient
    is rounding noise (the normalisation's Jacobian removes the radial
    part), so its Adam steps are compared only through the normalised
    rotation.
  * The events (importance sweep, SH cull, mercy prune) read the dataset's
    start poses in both packages.
  * cameras.json after the run: the JAX package's ``training`` writes the
    start poses; the port's writes the learned ones, and the cameras that
    ``prepare_dataset(load_camera=...)`` reads back render exactly what
    ``adjusted_camera`` renders.
"""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import combinations as tcomb  # noqa: E402
from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import TrainableCameraDataset  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import prepare_dataset  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.pruning import trainer as tp  # noqa: E402
from reduced_3dgs_torch.shculling import trainer as tsh  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer as TTrainer  # noqa: E402
from reduced_3dgs_torch.trainer import camera_trainer as tcam  # noqa: E402
from reduced_3dgs_tpu import combinations as jcomb  # noqa: E402
from reduced_3dgs_tpu import train as jtrain  # noqa: E402
from reduced_3dgs_tpu.importance import trainer as jimp  # noqa: E402
from reduced_3dgs_tpu.pruning import trainer as jp  # noqa: E402
from reduced_3dgs_tpu.shculling import trainer as jsh  # noqa: E402
from reduced_3dgs_tpu.trainer import Trainer as JTrainer  # noqa: E402
from reduced_3dgs_tpu.trainer import camera_trainer as jcam  # noqa: E402

from .test_torch_densification import toy_scene  # noqa: E402
from .test_torch_fixtures import (jax_dataset, jax_model, torch_dataset,  # noqa: E402
                                  torch_model, views_np)
from .test_torch_pruning import (RUN_CONFIG, check_decision_margins,  # noqa: E402
                                 check_losses_and_state, check_masks_and_row_counts,
                                 flagship_run)

TOL_DELTA = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-3, 3e-5
FD_STEP, FD_REL = 1e-3, 5e-3
# The learned deltas are ~1e-4 after 12 steps at the default rates
# (1e-4), so the poses are held to 1e-6, not 1e-4; a view has moved when
# some entry of its pose differs from the start by more than MOVED.
TOL_POSE = 1e-6
MOVED = 1e-5
GRAD_MARGIN = 1e-4
CAMERA_FIELDS = ("world_view_transform", "full_proj_transform", "camera_center")


def random_delta(rng):
    q = np.array([1.0, 0, 0, 0]) + rng.normal(0.0, 0.05, 4)
    q *= rng.uniform(0.5, 2.0)  # unnormalised: the normalisation is part of the map
    return {"rot": q.astype(np.float32), "trans": rng.normal(0.0, 0.1, 3).astype(np.float32)}


@pytest.mark.parametrize("seed", range(4))
def test_apply_camera_delta_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    cams = views_np(3, 40, 56)
    for jc, tc in zip(jax_dataset(cams), torch_dataset(cams)):
        delta = random_delta(rng)
        j = jcam._apply_camera_delta(jc, {k: jnp.asarray(v) for k, v in delta.items()})
        t = tcam._apply_camera_delta(tc, {k: torch.from_numpy(v) for k, v in delta.items()})
        for name in CAMERA_FIELDS:
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=TOL_DELTA, atol=TOL_DELTA, err_msg=name)
        np.testing.assert_array_equal(t.R.numpy(), t.world_view_transform[:3, :3].numpy())
        np.testing.assert_array_equal(t.T.numpy(), t.world_view_transform[3, :3].numpy())
        same = tcam._apply_camera_delta(tc, {"rot": torch.tensor([1.0, 0, 0, 0]),
                                             "trans": torch.zeros(3)})
        for name in CAMERA_FIELDS + ("R", "T"):
            assert torch.equal(getattr(same, name), getattr(tc, name)), name


# ------------------------------------------------------- one step's gcam
def _capture(trainer, grads):
    """Wrap ``trainer.camera_adjustment`` so that each step's camera
    gradient is appended to ``grads`` (as numpy) before it is consumed."""
    adjust = trainer.camera_adjustment

    def capturing(camera):
        params, apply, consume = adjust(camera)

        def consume_and_keep(g):
            grads.append({k: np.array(v) for k, v in g.items()})
            return consume(g)

        return params, apply, consume_and_keep

    trainer.camera_adjustment = capturing


def _jax_slots(jtr, jds):
    """The JAX trainer's slots as numpy, keyed by view index."""
    params, adam = {}, {}
    for i, cam in enumerate(jds):
        key = id(cam)
        if key in jtr._cam_params:
            params[i] = {k: np.array(v) for k, v in jtr._cam_params[key].items()}
            s = jtr._cam_adam[key]
            adam[i] = {"count": int(s.count), "m": {k: np.array(v) for k, v in s.m.items()},
                       "v": {k: np.array(v) for k, v in s.v.items()}}
    return params, adam


@pytest.fixture(scope="module")
def one_step():
    """Both packages' camera trainers over a Trainer, both slots set to the
    same random delta and Adam state (carried across from the JAX slots),
    and one step on view 1."""
    params, degrees, cams, images = toy_scene()
    jds, tds = jax_dataset(cams, images), torch_dataset(cams, images)
    jtr = jcam.CameraTrainerWrapper(JTrainer, jax_model(params, degrees), jds)
    ttr = tcam.CameraTrainerWrapper(TTrainer, torch_model(params, degrees), tds)
    rng = np.random.default_rng(310)
    view = jds[1]
    delta = random_delta(rng)
    jtr._slot(view)
    jtr._cam_params[id(view)] = {k: jnp.asarray(v) for k, v in delta.items()}
    jtr._cam_adam[id(view)] = jtr._cam_adam[id(view)]._replace(
        count=jnp.int32(3), m={k: jnp.asarray(0.01 * v) for k, v in delta.items()},
        v={k: jnp.asarray(1e-4 * v * v) for k, v in delta.items()})
    ttr.load_numpy(*_jax_slots(jtr, jds))
    j_grads, t_grads = [], []
    _capture(jtr, j_grads)
    _capture(ttr, t_grads)
    j_loss = float(jtr.step(view)[0])
    t_loss = float(ttr.step(tds[1])[0])
    return dict(jtr=jtr, ttr=ttr, jds=jds, tds=tds, j_grads=j_grads, t_grads=t_grads,
                j_loss=j_loss, t_loss=t_loss, delta=delta)


def test_camera_gradient_matches_jax(one_step):
    (jg,), (tg,) = one_step["j_grads"], one_step["t_grads"]
    assert one_step["t_loss"] == pytest.approx(one_step["j_loss"], rel=1e-5)
    g = np.concatenate([jg["rot"], jg["trans"]])
    assert np.abs(g).max() > 0
    for k in ("rot", "trans"):
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max(), err_msg=k)


def test_carried_slots_step_as_jax(one_step):
    """After the step the slot (delta and Adam moments) still matches the
    JAX slot: both took the same Adam step from the carried state."""
    jp_, ja = _jax_slots(one_step["jtr"], one_step["jds"])
    ttr = one_step["ttr"]
    key = id(one_step["tds"][1])
    assert ttr._cam_adam[key].count == ja[1]["count"] == 4
    for k in ("rot", "trans"):
        np.testing.assert_allclose(ttr._cam_params[key][k].detach().numpy(), jp_[1][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ttr._cam_adam[key].m[k].numpy(), ja[1]["m"][k],
                                   rtol=GRAD_RTOL, atol=1e-9, err_msg=k)


def smooth_scene():
    """Eight large, half-transparent Gaussians in front of view 0 (40x56):
    every pixel lies well inside each one's alpha cutoff, no alpha reaches
    the 0.99 clamp and no pixel's T the 1e-4 latch, so the loss is smooth
    in the pose (a small scene's loss otherwise jumps wherever a pixel
    crosses a cutoff, which a central difference counts and autodiff does
    not). The ground truth is the render of the scene with other colours."""
    rng = np.random.default_rng(320)
    n = 8
    params = dict(
        xyz=np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), rng.uniform(2.8, 3.2, (n, 1))], 1),
        features_dc=rng.normal(0.3, 0.3, (n, 1, 3)),
        features_rest=rng.normal(0.0, 0.1, (n, 15, 3)),
        scaling=np.log(rng.uniform(1.0, 1.3, (n, 3))),
        rotation=rng.normal(0.0, 0.2, (n, 4)) + np.array([1.0, 0, 0, 0]),
        opacity=rng.uniform(-0.5, 0.5, (n, 1)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    degrees = np.full(n, 3, np.int32)
    cams = views_np(1, 40, 56)
    other = dict(params, features_dc=params["features_dc"][::-1].copy())
    with torch.no_grad():
        gt = torch_model(other, degrees)(torch_dataset(cams)[0])["render"].numpy()
    return params, degrees, cams, [gt]


def test_camera_gradient_central_difference():
    """The port's own d loss / d trans against a central difference, on a
    scene whose loss is smooth in the pose."""
    params, degrees, cams, images = smooth_scene()
    tds = torch_dataset(cams, images)
    ttr = tcam.CameraTrainerWrapper(TTrainer, torch_model(params, degrees), tds)
    ttr.model.active_sh_degree = 3
    engine, view = ttr.engine, tds[0]
    loss_fn = ttr.loss_pure()
    rot = torch.tensor([0.999, 0.02, -0.03, 0.01])

    def loss_at(trans):
        cam = tcam._apply_camera_delta(view, {"rot": rot, "trans": trans})
        out = engine.model.render(cam)
        assert float(out["final_T"].detach().min()) > 1e-3
        return loss_fn(engine.model.param_dict(), out, cam, {"step": 0})

    trans = torch.tensor([0.02, -0.01, 0.03], requires_grad=True)
    loss_at(trans).backward()
    g = trans.grad.clone()
    assert g.abs().max() > 0
    with torch.no_grad():
        fd = torch.stack([
            (loss_at(trans + FD_STEP * e) - loss_at(trans - FD_STEP * e)) / (2 * FD_STEP)
            for e in torch.eye(3)])
    err = float((fd - g).abs().max() / g.abs().max())
    print(f"central difference: max|fd - g| / max|g| = {err:.3g}")
    assert err < FD_REL, (fd, g)


# --------------------------------------------- the camera flagship run
def _camera_flagship(package):
    def build(model, dataset):
        return package.CameraSHCullingOpacityResetFullReducedDensificationTrainer(
            model, dataset, **RUN_CONFIG)
    return build


def _pose_recorder(module, name, log):
    """Wrap ``module.name(model, dataset, ...)`` to log the dataset's
    world_view matrices at each call."""
    fn = getattr(module, name)

    def recording(model, dataset, *args, **kwargs):
        log.append((name, [np.array(c.world_view_transform) for c in dataset]))
        return fn(model, dataset, *args, **kwargs)

    return recording


@pytest.fixture(scope="module")
def run():
    """The toy run with the camera flagship in both packages, each step's
    camera gradients, and the poses every event read."""
    mp = pytest.MonkeyPatch()
    j_events, t_events = [], []
    for module, name, log in ((jp, "mercy_gaussians", j_events),
                              (jimp, "prune_list", j_events),
                              (jsh, "cull_sh_bands", j_events),
                              (tp, "mercy_gaussians", t_events),
                              (timp, "prune_list", t_events),
                              (tsh, "cull_sh_bands", t_events)):
        mp.setattr(module, name, _pose_recorder(module, name, log))
    j_build, t_build = _camera_flagship(jcomb), _camera_flagship(tcomb)
    j_grads, t_grads = [], []

    def j_capturing(model, dataset):
        trainer = j_build(model, dataset)
        _capture(trainer, j_grads)
        return trainer

    def t_capturing(model, dataset):
        trainer = t_build(model, TrainableCameraDataset(dataset.cameras, dataset.image_names))
        _capture(trainer, t_grads)
        return trainer

    try:
        out = flagship_run(j_capturing, t_capturing)
    finally:
        mp.undo()
    out.update(j_grads=j_grads, t_grads=t_grads, j_events=j_events, t_events=t_events)
    return out


def test_camera_flagship_decisions_have_margins(run):
    check_decision_margins(run)
    for g in run["t_grads"]:
        parts = np.concatenate([g["rot"][1:], g["trans"]])
        assert (np.abs(parts) > GRAD_MARGIN * np.abs(parts).max()).all(), g


def test_camera_flagship_masks_and_row_counts_match_jax(run):
    check_masks_and_row_counts(run)


def test_camera_flagship_losses_and_state_match_jax(run):
    check_losses_and_state(run)


def test_camera_flagship_poses_match_jax(run):
    """Each view's learned delta: the normalised rotation and ``trans``
    within TOL_POSE; every view moved."""
    jtr, ttr, tds = run["jtr"], run["ttr"], run["tds"]
    j_params, _ = _jax_slots(jtr, jtr.camera_dataset)
    assert sorted(j_params) == [0, 1, 2]
    for i, cam in enumerate(tds):
        t = {k: v.detach().numpy() for k, v in ttr._cam_params[id(cam)].items()}
        j = j_params[i]
        np.testing.assert_allclose(t["rot"] / np.linalg.norm(t["rot"]),
                                   j["rot"] / np.linalg.norm(j["rot"]), atol=TOL_POSE)
        np.testing.assert_allclose(t["trans"], j["trans"], atol=TOL_POSE)
        assert np.abs(t["trans"]).max() > MOVED
    assert len(run["t_grads"]) == len(run["j_grads"]) == len(run["t_losses"])


def test_events_read_the_start_poses(run):
    """The importance sweep, the SH cull and the mercy prune read each
    view's start pose in both packages, while the trainer has moved it."""
    start = [np.array(c.world_view_transform) for c in run["jtr"].camera_dataset]
    for events in (run["j_events"], run["t_events"]):
        assert sorted({name for name, _ in events}) == ["cull_sh_bands", "mercy_gaussians",
                                                        "prune_list"]
        for name, poses in events:
            assert len(poses) == len(start)
            for got, want in zip(poses, start):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=name)
    for cam in run["tds"]:
        moved = run["ttr"].adjusted_camera(cam).world_view_transform
        assert (moved - cam.world_view_transform).abs().max() > MOVED


def _poses(path):
    with open(path) as f:
        return [(np.array(e["rotation"]), np.array(e["position"])) for e in json.load(f)]


def test_cameras_json_holds_the_learned_poses(run, tmp_path):
    """``training`` with 0 steps only saves. The JAX package writes the
    start poses, not the ones its trainer learned; the port writes the
    learned ones, and reading them back renders as ``adjusted_camera``."""
    jtr, ttr, tds = run["jtr"], run["ttr"], run["tds"]
    jds = run["jtr"].camera_dataset
    jtrain.training(jds, jtr.model, jtr, None, str(tmp_path / "jax"), iteration=0,
                    save_iterations=[])
    ttrain.training(tds, ttr.model, ttr, None, str(tmp_path / "port"), iteration=0,
                    save_iterations=[], device="cpu")
    start = _poses(str(tmp_path / "jax" / "cameras.json"))
    port = _poses(str(tmp_path / "port" / "cameras.json"))
    for (jr, jt), (tr, tt), jc, tc in zip(start, port, jds, tds):
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = np.asarray(jc.R).T, np.asarray(jc.T)
        c2w = np.linalg.inv(w2c)
        np.testing.assert_allclose(jr, c2w[:3, :3], atol=1e-6)
        np.testing.assert_allclose(jt, c2w[:3, 3], atol=1e-6)
        learned = np.asarray(jcam._apply_camera_delta(
            jc, jtr._cam_params[id(jc)]).world_view_transform)
        assert np.abs(learned - np.asarray(jc.world_view_transform)).max() > MOVED
        assert np.abs(tt - jt).max() > MOVED
    loaded = prepare_dataset(str(tmp_path), device="cpu",
                             load_camera=str(tmp_path / "port" / "cameras.json"))
    model = ttr.model
    with torch.no_grad():
        for cam, back in zip(tds, loaded):
            adjusted = ttr.adjusted_camera(cam)
            for name in CAMERA_FIELDS:
                assert torch.equal(getattr(back, name), getattr(adjusted, name)), name
            assert torch.equal(model(back)["render"], model(adjusted)["render"])
    assert math.isfinite(float(run["t_losses"][-1]))
    assert os.path.exists(tmp_path / "port" / "point_cloud" / "iteration_0" / "point_cloud.ply")
