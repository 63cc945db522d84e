"""PyTorch port vs the JAX tool: the convergence proof
(``reduced_3dgs_torch/tools/convergence_proof.py`` against
``tools/convergence_proof.py``, loaded from its file).

  * ``surface_cloud`` bit for bit at two sizes and two seeds; the orbit's
    camera matrices and centres within 1e-6; the presets equal.
  * The whole slice: the JAX tool's own ``main()`` on a tiny preset of its
    own (3000 GT Gaussians, 500 init points, 48x64, 3 cameras, the ``full``
    preset's steps, threshold and noise), stopped at the flagship's and the
    baseline's constructors, which record what they were given. Against the
    port's ``build_scene`` and ``schedule``: the noisy ground truth within
    1e-4, the init cloud and colours exactly, the initial model within 1e-6,
    the scene extent within 1e-6, both kwarg dicts equal and the PSNR at
    init within 1e-3 dB.
  * The ``full`` schedule: each event kind's steps in 1..2000, found by
    driving each port event method on a stub (did it reach its work?),
    equal JAX's ``fires_at`` of the same class, and the tool's
    ``event_steps``.
  * A tiny end-to-end ``run()`` on the CPU (30 steps, every event kind
    firing), its result's keys, the trace, the quantized PLY, nothing
    written outside the work directory, and a run cut twice (once in each
    training loop) and resumed, which ends with the same numbers.
"""
import copy
import importlib.util
import json
import math
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reduced_3dgs_torch.quantization import ExcludeZeroSHQuantizer  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel  # noqa: E402
from reduced_3dgs_torch.tools import convergence_proof as cp  # noqa: E402
from reduced_3dgs_torch.trainer.densifier import NoopDensifier  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL_DIR = "/tmp/convergence_proof"     # the JAX tool's fixed directory
# The full preset's schedule (steps, threshold, noise) on a scene small
# enough for the CPU.
TINY = dict(n_gt=3000, n_init=500, hw=(48, 64), iters=2000, cams=3, noise=0.015,
            grad_thr=1e-4)
# 30 steps: split/clone and the opacity/mercy prune after 10, a reset every
# 3 steps to 15, the SH cull after 15, the importance prune after 20.
TINY_RUN = dict(TINY, iters=30)
TOL_IMAGE = 1e-4
TOL_PARAMS = 1e-6
TOL_PSNR_DB = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy runs gain nothing from intra-op threads, and beside the
    other test processes on the same cores they only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_proof", os.path.join(REPO, "tools", "convergence_proof.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _in_tool_dir(path):
    path = os.path.abspath(str(path))
    return path == JAX_TOOL_DIR or path.startswith(JAX_TOOL_DIR + os.sep)


class _OsProxy:
    """The JAX tool's ``os``, kept off its fixed directory: nothing there
    exists but ``present``, ``makedirs`` of it does nothing, and
    ``path.getsize`` of a PLY the patched savers did not write is 1."""

    def __init__(self, present):
        import types
        self.path = types.SimpleNamespace(**{k: getattr(os.path, k) for k in dir(os.path)
                                             if not k.startswith("__")})
        self.path.exists = lambda p: p in present or (not _in_tool_dir(p) and os.path.exists(p))
        self.path.getsize = lambda p: 1 if p.endswith(".ply") else os.path.getsize(p)

    def makedirs(self, path, *args, **kwargs):
        if not _in_tool_dir(path):
            os.makedirs(path, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(os, name)


class _NpProxy:
    """The JAX tool's ``np`` whose ``savez`` into its fixed directory (the
    GT cache) does nothing."""

    def savez(self, path, *args, **kwargs):
        if not _in_tool_dir(path):
            np.savez(path, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX tool's main() on TINY, recorded at its two constructors.

    The flagship's constructor records the model, dataset and kwargs and
    builds the real trainer (for its ``fires_at``). A partial record of a
    finished run, and a checkpoint that ``os.path.exists`` reports, make
    main() skip the training loop; the PLY writers are stubbed; the
    baseline's constructor records its kwargs and stops the run. The tool's
    fixed directory is neither read nor written: the GT images stay in
    memory."""
    import sys

    from reduced_3dgs_tpu import prepare as jprepare
    from reduced_3dgs_tpu import trainer as jtrainer
    from reduced_3dgs_tpu.models import GaussianModel as JGaussianModel
    from reduced_3dgs_tpu.quantization import ExcludeZeroSHQuantizer as JQuantizer
    from reduced_3dgs_tpu.shculling import VariableSHGaussianModel as JModel
    from reduced_3dgs_tpu.trainer import checkpoint as jcheckpoint

    tool = load_jax_tool()
    name = "torch_parity"
    out = str(tmp_path_factory.mktemp("jax_tool") / "result.json")
    with open(out + ".partial", "w") as f:
        json.dump({"preset": name, "psnr_init": 0.0, "n_points_peak": TINY["n_init"],
                   "history": [{"step": TINY["iters"], "loss": 0.0, "psnr": 0.0,
                                "n_points": TINY["n_init"]}]}, f)
    rec = {}
    real_flagship = jprepare.modes["densify-pruning-shculling"]
    real_create = JModel.create_from_pcd

    def flagship(model, ds, **kwargs):
        rec.update(flagship_kwargs=kwargs, model=model, dataset=ds,
                   trainer=real_flagship(model, ds, **kwargs))
        return rec["trainer"]

    def create_from_pcd(self, points, colors, **kwargs):
        rec.update(points=np.array(points), colors=np.array(colors))
        return real_create(self, points, colors, **kwargs)

    def baseline(model, ds, **kwargs):
        rec["baseline_kwargs"] = kwargs
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tool.PRESETS, name, TINY)
        mp.setitem(jprepare.modes, "densify-pruning-shculling", flagship)
        mp.setattr(JModel, "create_from_pcd", create_from_pcd)
        mp.setattr(jtrainer, "OpacityResetDensificationTrainer", baseline)
        mp.setattr(jcheckpoint, "load_checkpoint", lambda trainer, path: trainer)
        mp.setattr(JGaussianModel, "save_ply", lambda self, path: None)
        mp.setattr(JQuantizer, "save_quantized", lambda self, model, path: None)
        mp.setattr(tool, "os", _OsProxy({os.path.join(JAX_TOOL_DIR, f"ckpt_{name}.npz")}))
        mp.setattr(tool, "np", _NpProxy())
        mp.setattr(sys, "argv", ["convergence_proof.py", "--preset", name, "--device", "cpu",
                                 "--out", out])
        with pytest.raises(_Stop):
            tool.main()
    return rec


@pytest.fixture(scope="module")
def torch_scene():
    return cp.build_scene(TINY, TINY["cams"], TINY["noise"], "cpu")


# ----------------------------------------------------------- scene, cameras
@pytest.mark.parametrize("n,seed", [(3000, 0), (3000, 5), (20_001, 0), (20_001, 5)])
def test_surface_cloud_bit_equal(n, seed):
    want = load_jax_tool().surface_cloud(n, seed)
    got = cp.surface_cloud(n, seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n_cams,hw", [(24, (544, 976)), (3, (48, 64))])
def test_orbit_cameras_match_jax(n_cams, hw):
    want = load_jax_tool().orbit_cameras(n_cams, hw)
    got = cp.orbit_cameras(n_cams, hw, "cpu")
    assert len(got) == len(want) == n_cams
    for t, j in zip(got, want):
        assert (t.image_height, t.image_width) == hw == (j.image_height, j.image_width)
        assert t.FoVx == pytest.approx(float(j.FoVx), abs=1e-6)
        assert t.FoVy == pytest.approx(float(j.FoVy), abs=1e-6)
        for name in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=0, atol=1e-6, err_msg=name)


def test_presets_match_jax():
    assert cp.PRESETS == load_jax_tool().PRESETS


# --------------------------------------------------------------- the slice
def test_noisy_ground_truth_matches_jax(jax_side, torch_scene):
    want = [np.asarray(jax_side["dataset"][i].ground_truth_image)
            for i in range(len(jax_side["dataset"]))]
    got = [c.ground_truth_image.numpy() for c in torch_scene.cameras]
    assert len(got) == len(want) == TINY["cams"]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3,) + TINY["hw"]
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_IMAGE)
        assert 0.0 <= g.min() and g.max() <= 1.0
    # The noise is there: sigma 0.015 about the clean renders, less what
    # the clip at 0 and 1 takes.
    clean = cp.build_scene(TINY, TINY["cams"], 0.0, "cpu").cameras
    residual = np.stack(got) - np.stack([c.ground_truth_image.numpy() for c in clean])
    assert 0.01 < residual.std() < 0.016


def test_init_cloud_and_colours_exact(jax_side, torch_scene):
    assert np.array_equal(torch_scene.points.astype(np.float32), jax_side["points"])
    assert np.array_equal(torch_scene.colors.astype(np.float32), jax_side["colors"])
    assert torch_scene.points.shape == (TINY["n_init"], 3)


def test_initial_model_matches_jax(jax_side, torch_scene):
    jm, tm = jax_side["model"], torch_scene.model
    assert tm.num_points == jm.num_points == TINY["n_init"]
    for name, p in tm.param_dict().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jm.parameters()[name])[:tm.num_points],
                                   rtol=TOL_PARAMS, atol=TOL_PARAMS, err_msg=name)
    assert (tm._degrees == 3).all()
    assert tm.spatial_lr_scale == pytest.approx(jm.spatial_lr_scale, abs=1e-6)


def test_schedule_kwargs_match_jax(jax_side, torch_scene):
    extent = torch_scene.dataset.scene_extent()
    want_flag = dict(jax_side["flagship_kwargs"])
    want_base = dict(jax_side["baseline_kwargs"])
    assert extent == pytest.approx(want_flag.pop("scene_extent"), abs=1e-6)
    assert extent == pytest.approx(want_base.pop("scene_extent"), abs=1e-6)
    flag, base = cp.schedule(TINY, extent)
    assert flag.pop("scene_extent") == base.pop("scene_extent") == extent
    assert flag == want_flag
    assert base == want_base
    full_flag, full_base = cp.schedule(cp.PRESETS["full"], extent)
    assert (full_flag, full_base) == cp.schedule(TINY, extent)


def test_psnr_at_init_matches_jax(jax_side, torch_scene):
    from reduced_3dgs_tpu.utils.math import psnr as jpsnr
    ds = jax_side["dataset"]
    cams = [ds[i] for i in range(len(ds))]
    want = float(np.mean([float(jpsnr(jax_side["model"](c)["render"],
                                      c.ground_truth_image).mean())
                          for c in cams[::max(1, len(cams) // 6)]]))
    got = cp.eval_psnr(torch_scene.model, torch_scene.cameras)
    assert got == pytest.approx(want, abs=TOL_PSNR_DB)
    assert 5.0 < got < 30.0


# ------------------------------------------------------- the full schedule
class _Fired(Exception):
    pass


class _Tripwire:
    """A trainer whose engine and model may not be touched."""

    def __init__(self, step=0):
        self.curr_step = step

    def optim_step(self):
        return None

    @property
    def engine(self):
        raise _Fired

    @property
    def model(self):
        raise _Fired


def chain(trainer):
    """Every trainer wrapper and densifier, outermost first."""
    objs, t = [], trainer
    while t is not None:
        objs.append(t)
        d = getattr(t, "densifier", None)
        while d is not None:
            objs.append(d)
            d = getattr(d, "base_densifier", None)
        t = getattr(t, "base_trainer", None)
    return objs


def port_fired_steps(trainer, iters):
    """By class: the steps at which each event method, over a base that does
    nothing, reaches for the engine or the model (does work)."""
    from reduced_3dgs_torch.trainer import DensificationTrainer, DensifierWrapper, TrainerWrapper
    out = {}
    for obj in chain(trainer):
        if isinstance(obj, DensificationTrainer) or not isinstance(
                obj, (TrainerWrapper, DensifierWrapper)):
            continue
        steps = []
        for s in range(1, iters + 1):
            c = copy.copy(obj)
            try:
                if isinstance(c, DensifierWrapper):
                    c.base_densifier = NoopDensifier(None)
                    c.trainer = _Tripwire()
                    c.densify_and_prune(None, None, None, s)
                else:
                    c.base_trainer = _Tripwire(s)
                    c.optim_step()
            except _Fired:
                steps.append(s)
        if steps:
            out[type(obj).__name__] = steps
    return out


def jax_fires_at_steps(trainer, iters):
    """By class: JAX's ``fires_at`` of each chain member with its own
    cadence, over a base that never fires."""
    from reduced_3dgs_tpu.trainer import DensificationTrainer, NoopDensifier as JNoop
    from reduced_3dgs_tpu.trainer.abc import TrainerWrapper
    from reduced_3dgs_tpu.trainer.densifier.abc import DensifierWrapper

    class Never:
        def fires_at(self, step):
            return False

    plain = {TrainerWrapper.fires_at, DensifierWrapper.fires_at, DensificationTrainer.fires_at,
             JNoop.fires_at}
    out = {}
    for obj in chain(trainer):
        if type(obj).fires_at in plain or not hasattr(obj, "fires_at"):
            continue
        if not isinstance(obj, (TrainerWrapper, DensifierWrapper)):
            continue
        c = copy.copy(obj)
        if hasattr(c, "base_trainer"):
            c.base_trainer = Never()
        if hasattr(c, "base_densifier"):
            c.base_densifier = Never()
        out[type(obj).__name__] = [s for s in range(1, iters + 1) if c.fires_at(s)]
    return out


def test_full_schedule_event_steps_match_jax(jax_side, torch_scene):
    """Under ``full``: each event kind's steps from the port's event methods
    equal JAX's fires_at and the tool's event_steps; the crowded step 1000
    and the five importance sweeps are as the code (not the JAX comment's
    six) has them."""
    flag, _ = cp.schedule(cp.PRESETS["full"], torch_scene.dataset.scene_extent())
    model = copy.deepcopy(torch_scene.model)
    trainer = cp.modes["densify-pruning-shculling"](model, torch_scene.dataset, **flag)
    iters = cp.PRESETS["full"]["iters"]
    got = port_fired_steps(trainer, iters)
    want = jax_fires_at_steps(jax_side["trainer"], TINY["iters"])
    assert got == want
    assert got == cp.event_steps(trainer, iters)
    assert set(got) == {"SHCuller", "OpacityResetter", "BasePruner", "SplitCloneDensifier",
                        "ImportancePruner"}
    assert got["ImportancePruner"] == [1056, 1122, 1188, 1254, 1320]
    assert got["SHCuller"] == [1000]
    assert got["OpacityResetter"] == [200, 400, 600, 800, 1000]
    assert got["SplitCloneDensifier"] == list(range(40, 1001, 10))
    assert got["BasePruner"] == list(range(70, 1001, 10))


# ----------------------------------------------------------- end to end
with open(os.path.join(REPO, "CONVERGENCE_r05.json")) as _f:
    KEYS = set(json.load(_f)) | {"power_limit"}


class _Cut(Exception):
    pass


def test_run_end_to_end_and_resume(tmp_path, monkeypatch):
    """run() of TINY_RUN on the CPU: every event kind fires, N moves only at
    the scheduled steps, the result has the JAX artifact's keys, the trace
    agrees with the history, the quantized PLY loads back with the final N,
    and nothing lands outside the work directory. The same run cut in the
    reduced loop at step 16 and in the baseline at step 20, resumed each
    time, ends with the same history, trace and baseline."""
    torch.manual_seed(0)
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    seen = {"n": {}}

    def watch(tag, step, trainer):
        if tag == "reduced" and step == 1:
            seen["events"] = cp.event_steps(trainer, TINY_RUN["iters"])
        if tag == "reduced":
            seen["n"][step] = trainer.model.num_points

    whole = cp.run(TINY_RUN, device="cpu", workdir=str(tmp_path / "whole"), preset="tiny",
                   on_step=watch)
    assert sorted(os.listdir(tmp_path)) == ["cwd", "tmp", "whole"]
    assert os.listdir(cwd) == [] and os.listdir(tmp) == []

    events = seen["events"]
    assert all(events.get(k) for k in ("SHCuller", "OpacityResetter", "BasePruner",
                                       "SplitCloneDensifier", "ImportancePruner")), events
    movers = set(events["BasePruner"] + events["SplitCloneDensifier"]
                 + events["ImportancePruner"])
    n = [TINY_RUN["n_init"]] + [seen["n"][s] for s in range(1, TINY_RUN["iters"] + 1)]
    moved = {s for s in range(1, len(n)) if n[s] != n[s - 1]}
    assert moved and moved <= movers, (moved, movers)

    assert set(whole) == KEYS
    assert whole["bars_ok"] is None and whole["power_limit"] is None
    assert whole["device"] == "cpu"
    assert whole["n_points_peak"] >= whole["n_points_final"] == n[-1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["psnr"]) for r in whole["history"])
    by_step = {r["step"]: r["n_points"] for r in whole["history"]}
    assert [s for s, _ in whole["n_points_trace_10step"]] == [10, 20, 30]
    for s, count in whole["n_points_trace_10step"]:
        assert count == by_step[s] == n[s]
    with open(tmp_path / "whole" / "result.json") as f:
        assert json.load(f) == whole
    q = VariableSHGaussianModel(3, device="cpu")
    ExcludeZeroSHQuantizer().load_quantized(q, str(tmp_path / "whole" / cp.QUANTIZED_PLY))
    assert q.num_points == whole["n_points_final"]
    assert whole["quantized_ply_bytes"] < whole["raw_ply_bytes"]

    # Cut in the reduced loop, then in the baseline, resuming each time.
    cut_dir = str(tmp_path / "cut")

    def cut_at(tag_at, step_at):
        def on_step(tag, step, trainer):
            if (tag, step) == (tag_at, step_at):
                raise _Cut
        return on_step

    for tag, step in (("reduced", 16), ("baseline", 20)):
        with pytest.raises(_Cut):
            cp.run(TINY_RUN, device="cpu", workdir=cut_dir, preset="tiny",
                   resume=True, on_step=cut_at(tag, step))
    resumed = cp.run(TINY_RUN, device="cpu", workdir=cut_dir, preset="tiny", resume=True)
    for key in ("history", "n_points_trace_10step", "psnr_init", "n_points_peak",
                "n_points_final", "n_points_unpruned_baseline", "psnr_unpruned_baseline",
                "raw_ply_bytes", "quantized_ply_bytes"):
        assert resumed[key] == whole[key], key


# Two views at 24x32 and six steps: a few seconds a run on the CPU.
MICRO = dict(n_gt=600, n_init=100, hw=(24, 32), iters=6, cams=2, noise=0.015)


def test_main_twice_with_one_out_and_records_of_another_run(tmp_path, monkeypatch):
    """main() twice with the same --out and no --workdir: each run keeps its
    partial records in its own fresh work directory, so the second starts
    anew and ends as the first did. A work directory finished under one
    configuration, resumed under another (--noise 0), is not read: the
    result equals a fresh run's of the second configuration."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.setitem(cp.PRESETS, "micro", MICRO)
    out = str(tmp_path / "out.json")
    argv = ["--preset", "micro", "--device", "cpu", "--out", out]
    first = cp.main(argv)
    second = cp.main(argv)
    workdirs = sorted(tmp.iterdir())
    assert len(workdirs) == 2
    assert sorted(os.listdir(tmp_path)) == ["out.json", "tmp"]
    for key in ("history", "n_points_final", "n_points_unpruned_baseline",
                "psnr_unpruned_baseline"):
        assert second[key] == first[key], key

    resumed = cp.main(argv + ["--workdir", str(workdirs[0]), "--noise", "0"])
    fresh = cp.main(argv + ["--workdir", str(tmp_path / "fresh"), "--noise", "0"])
    assert resumed["scene"]["gt_noise_sigma"] == 0.0
    for key in ("psnr_init", "history", "n_points_final", "n_points_unpruned_baseline",
                "psnr_unpruned_baseline"):
        assert resumed[key] == fresh[key], key
    assert resumed["psnr_init"] != first["psnr_init"]


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cp.main(["--preset", "smoke", "--workdir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
