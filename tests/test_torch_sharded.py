"""PyTorch port vs JAX package: ``parallel/`` over real processes.

Three groups of processes run the port on the CPU over gloo, each started
from tests/_torch_mesh_worker.py with its own timeout, all at once while
this process computes the JAX package's sharded results on its 8-device CPU
mesh:

  * ``steps``, four ranks on a 2x2 mesh, on a 24-Gaussian scene of two 32x32
    views. Each mirrors a JAX test: one ShardedTrainer step with view 0 on
    both data ranks against JAX's and against the port's single-device step
    (rtol 2e-3, atol 2e-5: JAX tests/test_parallel.py:67); the densification
    statistics of a step over [view 0, view 1] against JAX's (denominators
    exact, accumulators rtol 2e-3) and against two single-device steps (the
    denominators exact, the accumulators within JAX's bar, rtol 0.35:
    :175); a camera trainer's short batch (one camera for two data ranks
    steps its slot once, test_sharded_flagship.py:121) and its deltas after
    three steps (:104); the sharded importance and colour sweeps against
    JAX's and against the single-device sweeps (counts exact, scores 1e-5,
    variance rtol 1e-3: :73, :85); the 2DGS model's two steps (:130); and
    render_sharded against the full render.
  * ``main2x1`` and ``main1x2``, two ranks each: ``train.main --mesh 2x1``
    and ``--mesh 1x2 --device cpu`` in the flagship mode on a COLMAP dataset
    of three 24x32 views, through its split, prune, importance and cull
    events (test_sharded_flagship.py:36). N must move at the events, and
    the 1x2 run, which takes the single-process run's cameras, matches it:
    N after every step exact, the losses at rtol 1e-4.

In every group the ranks' results (parameters, degrees, statistics, losses)
must be bitwise equal (JAX test_parallel.py:101): the replicas stay equal.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.dataset.colmap import colmap_init  # noqa: E402
from reduced_3dgs_torch.dataset.dataset import prepare_dataset  # noqa: E402
from reduced_3dgs_torch.importance.trainer import prune_list  # noqa: E402
from reduced_3dgs_torch.ops.shculling_stats import calculate_colours_variance  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer  # noqa: E402
from reduced_3dgs_tpu import parallel as jparallel  # noqa: E402
from reduced_3dgs_tpu.parallel.stats import (sharded_colours_variance,  # noqa: E402
                                             sharded_prune_list)
from reduced_3dgs_tpu.shculling import VariableSHGsplat2DGSGaussianModel as J2DGS  # noqa: E402
from reduced_3dgs_tpu.trainer.camera_trainer import CameraTrainer as JCameraTrainer  # noqa: E402

from .test_torch_fixtures import (jax_dataset, jax_model, random_cloud_np,  # noqa: E402
                                  torch_dataset, torch_model, views_np)
from .test_torch_pruning import write_colmap  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
GROUP_TIMEOUT = 60
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
N_GAUSSIANS, HW = 24, 32
MAIN_STEPS = 12
# The flagship's events on the COLMAP toy dataset: split after step 3, the
# opacity and mercy prune after 5, the importance prune after 7, the SH cull
# after 9.
MAIN_OPTIONS = dict(sh_degree_up_interval=2, densify_from_iter=3, densify_until_iter=3,
                    densify_interval=3, densify_grad_threshold=0.0002,
                    prune_from_iter=5, prune_until_iter=5, prune_interval=5, box_size=3.0,
                    importance_prune_from_iter=7, importance_prune_until_iter=7,
                    importance_prune_interval=7, importance_prune_thr_important_score=1e9,
                    cull_at_steps=[9], cdist_threshold=0.3, std_threshold=0.01,
                    opacity_reset_interval=100)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Group:
    """The ranks of one job, started at once; ``results`` waits for them
    (failing the test on a rank's error or at the group's timeout, with
    every rank killed) and loads what each wrote."""

    def __init__(self, job, work, world, args=()):
        self.job, self.work, self.world = job, work, world
        self.start = time.monotonic()
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, job, work, *args], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    left = GROUP_TIMEOUT - (time.monotonic() - self.start)
                    logs.append(p.communicate(timeout=max(left, 0.1))[0])
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"{self.job}: the ranks did not finish in {GROUP_TIMEOUT} s")
            for rank, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"{self.job} rank {rank} failed:\n{log[-4000:]}"
            self._results = [torch.load(os.path.join(self.work, f"{self.job}_rank{r}.pt"),
                                        weights_only=False) for r in range(self.world)]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _main_args(src, out, mesh):
    args = ["-s", src, "-d", out, "-i", str(MAIN_STEPS), "--device", "cpu",
            "--save_iterations", str(MAIN_STEPS)]
    args += [a for k, v in MAIN_OPTIONS.items() for a in ("-o", f"{k}={v!r}")]
    return args + (["--mesh", mesh] if mesh else [])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The 2x2 scene (numpy) and a COLMAP dataset with images; the three
    groups of processes, started."""
    work = tmp_path_factory.mktemp("mesh")
    params, degrees = random_cloud_np(71, N_GAUSSIANS)
    gt_params, gt_degrees = random_cloud_np(72, N_GAUSSIANS)
    cams = views_np(2, HW, HW)
    with torch.no_grad():
        gt = torch_model(gt_params, gt_degrees)
        images = [torch.clamp(gt(c)["render"], 0, 1).numpy() for c in torch_dataset(cams)]
    torch.save(dict(params=params, degrees=degrees, cams=cams, images=images),
               work / "scene.pt")

    src = str(work / "colmap")
    rng = np.random.default_rng(73)
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

    groups = {"steps": _Group("steps", str(work), 4)}
    for mesh in ("2x1", "1x2"):
        os.makedirs(work / mesh)
        groups[f"main{mesh}"] = _Group("main", str(work / mesh), 2,
                                       _main_args(src, str(work / mesh), mesh))
    yield dict(params=params, degrees=degrees, cams=cams, images=images, src=src, work=work,
               groups=groups)
    for g in groups.values():
        g.kill()


def _jax_mesh():
    return jparallel.make_mesh(n_data=2, n_tile=2, devices=jax.devices()[:4])


def _jax_state(model):
    """The JAX model's live rows (its arrays are padded to a capacity)."""
    return {k: np.asarray(v)[:model.num_points] for k, v in model.parameters().items()}


def _datasets(scene):
    imgs = [np.asarray(i) for i in scene["images"]]
    return (jax_dataset(scene["cams"], imgs),
            torch_dataset(scene["cams"], [torch.from_numpy(i) for i in imgs]))


def _assert_state_close(got, want, keys=None, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    for k in keys or ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                      "opacity"):
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_mesh_places_the_ranks(scene):
    res = scene["groups"]["steps"].results()
    assert [r["mesh"] for r in res] == [({"data": 2, "tile": 2}, d, t)
                                        for d in range(2) for t in range(2)]


@pytest.mark.parametrize("job", ["grad", "stats", "cameras", "sweeps", "2dgs",
                                 "main2x1", "main1x2"])
def test_ranks_hold_equal_replicas(scene, job):
    """Every rank ends with the same bits; a step's render is each data
    rank's own camera's, the same on the ranks of one mesh row."""
    if job.startswith("main"):
        res = scene["groups"][job].results()
    else:
        res = [r[job] for r in scene["groups"]["steps"].results()]
    for r in res[1:]:
        if job == "stats":
            assert _equal({k: v for k, v in r.items() if k != "render"},
                          {k: v for k, v in res[0].items() if k != "render"})
        else:
            assert _equal(r, res[0])
    if job == "stats":
        assert torch.equal(res[0]["render"], res[1]["render"])
        assert torch.equal(res[2]["render"], res[3]["render"])
        assert not torch.equal(res[0]["render"], res[2]["render"])


@pytest.fixture(scope="module")
def jax_steps(scene):
    """JAX's ShardedTrainer on its 2x2 mesh: one step over [view 0, view 0]
    and one over [view 0, view 1] from the same start."""
    jds, _ = _datasets(scene)
    out = {}
    for name, views in (("grad", (0, 0)), ("stats", (0, 1))):
        jm = jax_model(scene["params"], scene["degrees"])
        trainer = jparallel.ShardedTrainer(jm, jds, mesh=_jax_mesh())
        loss, _ = jparallel.shard_train_step(trainer, [jds[i] for i in views])
        out[name] = dict(_jax_state(jm), loss=float(loss),
                         xyz_grad_accum=np.asarray(trainer.xyz_grad_accum)[:jm.num_points],
                         xyz_grad_denom=np.asarray(trainer.xyz_grad_denom)[:jm.num_points],
                         max_radii2d=np.asarray(trainer.max_radii2d)[:jm.num_points])
    return out


def test_sharded_step_matches_jax(scene, jax_steps):
    got = scene["groups"]["steps"].results()[0]["grad"]
    _assert_state_close(got, jax_steps["grad"])
    np.testing.assert_allclose(float(got["loss"]), jax_steps["grad"]["loss"], rtol=1e-5)


def test_sharded_step_matches_single_device(scene):
    """View 0 on both data ranks: the mesh mean is the single-device
    gradient, and Adam's step the same."""
    _, tds = _datasets(scene)
    tm = torch_model(scene["params"], scene["degrees"])
    loss, _ = Trainer(tm, tds).step(tds[0])
    got = scene["groups"]["steps"].results()[0]["grad"]
    _assert_state_close(got, {k: p.detach().numpy() for k, p in tm.param_dict().items()})
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)


def test_densify_stats_match_jax(scene, jax_steps):
    got, want = scene["groups"]["steps"].results()[0]["stats"], jax_steps["stats"]
    np.testing.assert_array_equal(got["xyz_grad_denom"].numpy(), want["xyz_grad_denom"])
    np.testing.assert_array_equal(got["max_radii2d"].numpy(), want["max_radii2d"])
    accum = want["xyz_grad_accum"]
    np.testing.assert_allclose(got["xyz_grad_accum"].numpy(), accum, rtol=GRAD_RTOL,
                               atol=3e-5 * np.abs(accum).max())
    _assert_state_close(got, want)


def test_densify_stats_match_single_device_steps(scene):
    """The denominators count each visible rank as two single-device steps
    count each step; the accumulators differ only as the second camera's
    gradient is taken at the first step's parameters there (JAX's bar)."""
    _, tds = _datasets(scene)
    tm = torch_model(scene["params"], scene["degrees"])
    single = Trainer(tm, tds)
    single.step(tds[0])
    single.step(tds[1])
    got = scene["groups"]["steps"].results()[0]["stats"]
    denom = single.xyz_grad_denom.numpy()
    np.testing.assert_array_equal(got["xyz_grad_denom"].numpy(), denom)
    live = denom > 0
    assert live.any() and (denom == 2).any()
    np.testing.assert_allclose(got["xyz_grad_accum"].numpy()[live],
                               single.xyz_grad_accum.numpy()[live], rtol=0.35, atol=1e-6)
    assert (got["xyz_grad_accum"].numpy()[~live] == 0).all()


@pytest.fixture(scope="module")
def jax_cameras(scene):
    jds, _ = _datasets(scene)
    jm = jax_model(scene["params"], scene["degrees"])
    ct = JCameraTrainer(jparallel.ShardedTrainer(jm, jds, mesh=_jax_mesh()), jds)
    losses = [float(ct.step([jds[0]])[0])]
    losses += [float(ct.step([jds[0], jds[1]])[0]) for _ in range(2)]
    return dict(_jax_state(jm), losses=np.array(losses),
                **{f"{k}{i}": np.asarray(ct._cam_params[id(jds[i])][k])
                   for i in range(2) for k in ("rot", "trans")})


def test_short_batch_wraps(scene):
    """One camera for two data ranks: both render it, and its Adam slot
    steps once; then two steps over both views."""
    got = scene["groups"]["steps"].results()[0]["cameras"]
    assert got["count_after_short"] == 1
    assert (got["count0"], got["count1"]) == (3, 2)
    assert torch.isfinite(got["losses"]).all()


def test_trainable_cameras_match_jax(scene, jax_cameras):
    got = scene["groups"]["steps"].results()[0]["cameras"]
    np.testing.assert_allclose(got["losses"].numpy(), jax_cameras["losses"], rtol=1e-5)
    for i in range(2):
        rot, jrot = got[f"rot{i}"].numpy(), jax_cameras[f"rot{i}"]
        assert np.abs(got[f"trans{i}"].numpy()).max() > 0
        np.testing.assert_allclose(rot / np.linalg.norm(rot), jrot / np.linalg.norm(jrot),
                                   atol=1e-6)
        np.testing.assert_allclose(got[f"trans{i}"].numpy(), jax_cameras[f"trans{i}"],
                                   atol=1e-6)
    _assert_state_close(got, jax_cameras)


@pytest.fixture(scope="module")
def single_sweeps(scene):
    """The single-device sweeps of the port and the sharded ones of JAX."""
    jds, tds = _datasets(scene)
    tm = torch_model(scene["params"], scene["degrees"])
    tm.active_sh_degree = 3
    params = {k: p.detach() for k, p in tm.param_dict().items()}
    count, op, ta = prune_list(tm, tds)
    dist, var, mean = calculate_colours_variance(list(tds), tm, params,
                                                 tm.aux_state()["degrees"], 3)
    port = dict(count=count.numpy(), opacity=op.numpy(), t_alpha=ta.numpy(),
                dist=dist.numpy(), var=var.numpy(), mean=mean.numpy())
    jm = jax_model(scene["params"], scene["degrees"])
    jm.active_sh_degree = 3
    mesh = _jax_mesh()
    jcount, jop, jta = sharded_prune_list(jm, jds, mesh)
    jdist, jvar, jmean = sharded_colours_variance(
        list(jds), jm, jm.parameters(), jm.aux_state()["degrees"], 3, jm.alive_mask, mesh)
    jax_ = dict(count=jcount, opacity=jop, t_alpha=jta, dist=jdist, var=jvar, mean=jmean)
    return {"single": port, "jax": {k: np.asarray(v) for k, v in jax_.items()}}


@pytest.mark.parametrize("against", ["jax", "single"])
@pytest.mark.parametrize("sweep", ["prune_list", "colours_variance"])
def test_sharded_sweeps_match(scene, single_sweeps, against, sweep):
    got = {k: v.numpy() for k, v in scene["groups"]["steps"].results()[0]["sweeps"].items()}
    want = single_sweeps[against]
    if sweep == "prune_list":
        assert got["count"].dtype == np.int32 and got["count"].sum() > 0
        np.testing.assert_array_equal(got["count"], want["count"])
        for k in ("opacity", "t_alpha"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["var"], want["var"], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-4, atol=1e-5)


def test_2dgs_model_matches_jax(scene):
    """The surfel model shards through the same render_band hook."""
    jds, _ = _datasets(scene)
    jm = J2DGS(3)
    jm.set_parameters({k: jnp.asarray(v) for k, v in scene["params"].items()})
    jm.aux_set({"degrees": jnp.asarray(scene["degrees"])})
    trainer = jparallel.ShardedTrainer(jm, jds, mesh=_jax_mesh())
    losses = [float(trainer.step([jds[0], jds[1]])[0]) for _ in range(2)]
    got = scene["groups"]["steps"].results()[0]["2dgs"]
    np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=1e-5)
    _assert_state_close(got, _jax_state(jm))


def test_render_sharded_matches_the_full_render(scene):
    _, tds = _datasets(scene)
    with torch.no_grad():
        full = torch_model(scene["params"], scene["degrees"])(tds[0])["render"]
    for r in scene["groups"]["steps"].results():
        np.testing.assert_allclose(r["render_sharded"].numpy(), full.numpy(), rtol=0,
                                   atol=1e-5)


def test_flagship_main_2x1(scene):
    """Two cameras a step through the events; rank 0 alone wrote the files."""
    res = scene["groups"]["main2x1"].results()
    n = res[0]["n"]
    assert len(n) == MAIN_STEPS and len(set(n)) > 1, n
    assert all(np.isfinite(res[0]["losses"].numpy()))
    assert int(res[0]["degrees"].min()) < 3          # the cull fired
    out = scene["work"] / "2x1"
    saved = TModel(3, device="cpu").load_ply(
        str(out / "point_cloud" / f"iteration_{MAIN_STEPS}" / "point_cloud.ply"))
    assert saved.num_points == n[-1]
    np.testing.assert_array_equal(saved._xyz.detach().numpy(), res[1]["xyz"].numpy())
    assert (out / "cameras.json").exists() and (out / "cfg_args").exists()


def test_flagship_main_1x2_matches_single_process(scene, tmp_path):
    """Each camera in two bands: the single-process run's cameras, N and
    losses."""
    rec = {"n": []}
    training = ttrain.training

    def recording(**kwargs):
        take_step, model = kwargs["trainer"].step, kwargs["gaussians"]

        def step(camera):
            out = take_step(camera)
            rec["n"].append(model.num_points)
            return out

        kwargs["trainer"].step = step
        return training(**kwargs)

    ttrain.training = recording
    try:
        losses = ttrain.main(_main_args(scene["src"], str(tmp_path), None))
    finally:
        ttrain.training = training
    res = scene["groups"]["main1x2"].results()
    assert res[0]["n"] == rec["n"] and len(set(rec["n"])) > 1, (res[0]["n"], rec["n"])
    np.testing.assert_allclose(res[0]["losses"].numpy(), torch.stack(losses).numpy(),
                               rtol=1e-4)
