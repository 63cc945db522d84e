"""PyTorch port vs JAX package: the fused step windows and the static key
buffer.

  * ``bin_and_sort`` with a key buffer of K slots against JAX's, at K at or
    above the entry count and below it (truncated at the end of the emission
    order): the valid entries, the tile ranges, ``overflow`` and
    ``num_rendered`` exactly, and the overflowing render's image at the JAX
    package's image bars.
  * The buffer's tail reaches no Gaussian: a render with K = 2 x the entry
    count has the exact buffer's gradient, bit for bit on the CPU.
  * ``fires_at`` and ``max_window(16)`` from every step of a cut schedule,
    for the flagship, ``densify-shculling``, reduction and quantizing
    chains, against JAX's; and tests/test_step_many.py's SH warm-up case.
  * ``update_many`` of six cameras: bit for bit six ``update``s on the CPU,
    and JAX's ``update_many`` at its bars (tests/test_step_many.py:53-80).
  * ``train.training`` in windows of 16 and of 1 on a flagship toy run:
    the same losses, N after every step and saved PLY, and the windows the
    JAX package's ``train.training`` takes.
  * The key buffer's policy on a scripted sequence of drains against JAX's
    ``_note_overflow``, snapshot included.
  * Trainable cameras and windows of cameras that differ in size or ground
    truth take single steps.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import prepare as tprepare  # noqa: E402
from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.importance import BaseImportancePruningTrainer as TImp  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import tiled as ttiled  # noqa: E402
from reduced_3dgs_torch.shculling import SHCullingTrainerWrapper as TSHWrapper  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer as TBaseTrainer  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer as TTrainer  # noqa: E402
from reduced_3dgs_torch.trainer.camera_trainer import CameraTrainer  # noqa: E402
from reduced_3dgs_tpu import prepare as jprepare  # noqa: E402
from reduced_3dgs_tpu import train as jtrain  # noqa: E402
from reduced_3dgs_tpu.importance import BaseImportancePruningTrainer as JImp  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import common as jcommon  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import tiled as jtiled  # noqa: E402
from reduced_3dgs_tpu.shculling import SHCullingTrainerWrapper as JSHWrapper  # noqa: E402
from reduced_3dgs_tpu.trainer import BaseTrainer as JBaseTrainer  # noqa: E402
from reduced_3dgs_tpu.trainer import Trainer as JTrainer  # noqa: E402

from .test_torch_fixtures import (activated_np, camera_np, jax_args, jax_dataset,  # noqa: E402
                                  jax_model, jax_settings, random_cloud_np, torch_args,
                                  torch_dataset, torch_model, torch_settings, views_np)

N = 80
HW = (40, 56)
# The JAX package's bars for its Pallas kernel against its XLA path
# (tests/test_pallas_kernel.py:27-32) and for update_many against its
# sequential steps (tests/test_step_many.py:63-78).
ATOL_IMAGE, ATOL_DEPTH = 1e-4, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy scenes gain nothing from intra-op threads, and beside other
    test processes on the same cores they only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    """80 Gaussians, their perturbed start and four 40x56 views with the
    port's renders of the unperturbed scene as ground truth."""
    params, degrees = random_cloud_np(31, N, spread=0.9)
    cams = views_np(4, *HW)
    gt = torch_model(params, degrees)
    with torch.no_grad():
        images = [torch.clamp(gt.render(c)["render"], 0, 1).numpy()
                  for c in torch_dataset(cams)]
    rng = np.random.default_rng(32)
    start = {k: (v + 0.02 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
    return dict(params=params, start=start, degrees=degrees, cams=cams, images=images)


# --------------------------------------------------------------- binning
@pytest.fixture(scope="module")
def binned(scene):
    """Both packages' preprocess of the scene at view 0 (the JAX one feeds
    both binners) and the exact entry count."""
    cam = scene["cams"][0]
    pre = jcommon.preprocess(*jax_args(activated_np(scene["params"])), jax_settings(cam))
    tiles_x, tiles_y = jcommon.tile_grid(jax_settings(cam))
    inputs = [np.array(a) for a in (pre.rect_min, pre.rect_max, pre.tiles_touched,
                                    pre.depths)]
    exact = ttiled.bin_and_sort(*map(torch.from_numpy, inputs), tiles_x, tiles_y)
    return dict(inputs=inputs, tiles=(tiles_x, tiles_y), total=exact["num_rendered"],
                exact=exact)


@pytest.mark.parametrize("share", [2.0, 1.0, 0.6])
def test_static_binning_matches_jax(binned, share):
    """K = share x the entry count: the JAX binner's valid entries, their
    tile ranges, overflow and num_rendered, exactly; K >= the count also
    equals the exact binning."""
    tiles_x, tiles_y = binned["tiles"]
    num_tiles = tiles_x * tiles_y
    total = binned["total"]
    K = int(share * total)
    jent = jtiled.bin_and_sort(*map(jnp.asarray, binned["inputs"]), tiles_x=tiles_x,
                               tiles_y=tiles_y, tile_row_offset=jnp.int32(0), K=K)
    tent = ttiled.bin_and_sort(*map(torch.from_numpy, binned["inputs"]), tiles_x, tiles_y,
                               key_buffer_size=K)
    j_valid = np.asarray(jent["s_valid"])
    n_valid = int(j_valid.sum())
    assert n_valid == min(K, total) and j_valid[:n_valid].all()
    assert tent["valid"].numpy().tolist() == j_valid.tolist()
    assert int(tent["num_rendered"]) == int(jent["total"]) == total
    assert bool(tent["overflow"]) == bool(jent["overflow"]) == (total > K)
    j_tile = np.asarray(jent["s_tile"])
    np.testing.assert_array_equal(tent["s_tile"].numpy()[:n_valid], j_tile[:n_valid])
    np.testing.assert_array_equal(tent["s_gidx"].numpy()[:n_valid],
                                  np.asarray(jent["s_gidx"])[:n_valid])
    assert (tent["s_tile"].numpy()[n_valid:] == num_tiles).all()
    assert (tent["s_gidx"].numpy()[n_valid:] >= N).all()
    tiles = np.arange(num_tiles)
    np.testing.assert_array_equal(tent["range_start"].numpy(),
                                  np.searchsorted(j_tile, tiles, side="left"))
    np.testing.assert_array_equal(tent["range_end"].numpy(),
                                  np.searchsorted(j_tile, tiles, side="right"))
    if K >= total:
        for k in ("s_gidx", "s_tile"):
            assert torch.equal(tent[k][:total], binned["exact"][k])
        for k in ("range_start", "range_end"):
            assert torch.equal(tent[k], binned["exact"][k])


def test_overflowing_render_matches_jax(scene, binned):
    """The render truncated at 0.6 x its entries: JAX's XLA render at the
    same K within the image bars, and far from the whole render."""
    cam = scene["cams"][0]
    K = int(0.6 * binned["total"])
    settings = jax_settings(cam)
    jout = jax.jit(lambda *a: jtiled.render_tiled(*a, settings, key_buffer_size=K))(
        *jax_args(activated_np(scene["params"])))
    tout = ttiled.render_tiled(*torch_args(activated_np(scene["params"])),
                               torch_settings(cam), key_buffer_size=K)
    whole = ttiled.render_tiled(*torch_args(activated_np(scene["params"])),
                                torch_settings(cam))
    assert bool(tout["overflow"]) and bool(jout["overflow"])
    np.testing.assert_allclose(tout["render"].numpy(), np.asarray(jout["render"]),
                               atol=ATOL_IMAGE, rtol=0)
    np.testing.assert_allclose(tout["final_T"].numpy(), np.asarray(jout["final_T"]),
                               atol=ATOL_IMAGE, rtol=0)
    np.testing.assert_allclose(tout["depth"].numpy(), np.asarray(jout["depth"]),
                               atol=ATOL_DEPTH, rtol=0)
    assert float((tout["render"] - whole["render"]).abs().max()) > 100 * ATOL_IMAGE


def test_buffer_tail_reaches_no_gaussian(scene):
    """Twice the entries: the tail's per-entry gradients go to the dropped
    scratch row, so every parameter's gradient is the exact buffer's, bit
    for bit; so are the image and the statistics of a statistics render."""
    cam = torch_dataset(scene["cams"][:1])[0]
    gt = torch.from_numpy(scene["images"][0])
    with torch.no_grad():
        total = torch_model(scene["start"], scene["degrees"]).render(cam)["num_rendered"]
    results = {}
    for K in (None, total, 2 * total):
        model = torch_model(scene["start"], scene["degrees"])
        out = model.render(cam, key_buffer_size=K)
        ((out["render"] - gt) ** 2).sum().add(out["depth"].sum()).backward()
        with torch.no_grad():
            stats = model.render(cam, with_stats=True, key_buffer_size=K)
        results[K] = (out["render"].detach(), {k: p.grad for k, p in model.param_dict().items()},
                      stats)
    ref_img, ref_grads, ref_stats = results[None]
    for K in (total, 2 * total):
        img, grads, stats = results[K]
        assert torch.equal(img, ref_img)
        for k, g in ref_grads.items():
            assert torch.equal(grads[k], g), k
        for k in ("gaussians_count", "opacity_important_score", "T_alpha_important_score",
                  "transmittance_sum"):
            assert torch.equal(stats[k], ref_stats[k]), k


# ------------------------------------------------------------- windows
def _chains(scene, jds, tds):
    """(name, port trainer, JAX trainer) of four chains on a cut schedule."""
    flagship = dict(densify_from_iter=4, densify_until_iter=40, densify_interval=10,
                    densify_grad_threshold=1e-6, prune_from_iter=8, prune_until_iter=40,
                    prune_interval=10, opacity_reset_interval=20,
                    opacity_reset_until_iter=30, importance_prune_from_iter=30,
                    importance_prune_until_iter=40, importance_prune_interval=10,
                    cull_at_steps=(35,), sh_degree_up_interval=15)
    densify = dict(densify_from_iter=3, densify_until_iter=30, densify_interval=6,
                   prune_from_iter=5, prune_until_iter=33, prune_interval=7,
                   opacity_reset_interval=13, opacity_reset_until_iter=26,
                   cull_at_steps=(17, 29), sh_degree_up_interval=9)
    reduction = dict(importance_prune_from_iter=10, importance_prune_until_iter=30,
                     importance_prune_interval=10, cull_at_steps=(15, 33),
                     sh_degree_up_interval=4)
    quantize = dict(flagship, quantize_from_iter=6, quantize_until_iter=38,
                    quantize_interval=8, num_clusters=8)
    chains = []

    def models():
        return (torch_model(scene["start"], scene["degrees"]),
                jax_model(scene["start"], scene["degrees"]))

    for name, mode, cfg, q in (("flagship", "densify-pruning-shculling", flagship, False),
                               ("densify-shculling", "densify-shculling", densify, False),
                               ("quantizing", "densify-pruning-shculling", quantize, True)):
        tm, jm = models()
        t = tprepare.prepare_trainer(tm, tds, mode, quantize=q, configs=cfg)[0]
        j = jprepare.prepare_trainer(jm, jds, mode, quantize=q, configs=cfg)[0]
        chains.append((name, t, j))
    tm, jm = models()
    chains.append(("reduction", TSHWrapper(TImp, tm, tds, **reduction),
                   JSHWrapper(JImp, jm, jds, **reduction)))
    return chains


def test_fires_at_and_max_window_match_jax(scene):
    jds, tds = jax_dataset(scene["cams"]), torch_dataset(scene["cams"])
    for name, t, j in _chains(scene, jds, tds):
        fires = [t.fires_at(s) for s in range(0, 45)]
        assert fires == [bool(j.fires_at(s)) for s in range(0, 45)], name
        assert any(fires), name
        windows = []
        for s in range(0, 45):
            t.curr_step = j.curr_step = s
            windows.append((t.max_window(16), j.max_window(16)))
        assert [a for a, _ in windows] == [b for _, b in windows], name
        assert max(a for a, _ in windows) > 1, name
    # tests/test_step_many.py:168-182: the SH warm-up ends a window before
    # the step that starts with the bump.
    for cls, model, ds in ((TTrainer, torch_model, tds), (JTrainer, jax_model, jds)):
        tr = cls(model(scene["start"], scene["degrees"]), ds, sh_degree_up_interval=7)
        assert tr.max_window(16) == 7
        tr.curr_step = 5
        assert tr.max_window(16) == 2


def test_update_many_equals_single_steps_and_jax(scene):
    """Six cameras: the port's window is its six single steps bit for bit,
    and the JAX engine's window at its own bars."""
    tds = torch_dataset(scene["cams"], scene["images"])
    jds = jax_dataset(scene["cams"], scene["images"])
    order = [0, 1, 2, 3, 0, 2]
    single = TBaseTrainer(torch_model(scene["start"], scene["degrees"]), tds)
    windowed = TBaseTrainer(torch_model(scene["start"], scene["degrees"]), tds)
    j = JBaseTrainer(jax_model(scene["start"], scene["degrees"]), jds)
    s_losses = [single.update(single, tds[i])[0] for i in order]
    w_losses, ys = windowed.update_many(windowed, [tds[i] for i in order])
    j_losses, j_ys = j.update_many(j, [jds[i] for i in order])

    assert [float(x) for x in w_losses] == [float(x) for x in s_losses]
    for k, p in single.model.param_dict().items():
        assert torch.equal(windowed.model.param_dict()[k], p), k
    for k in ("xyz_grad_accum", "xyz_grad_denom", "max_radii2d"):
        assert torch.equal(getattr(windowed, k), getattr(single, k)), k
    assert windowed.curr_step == single.curr_step == 6
    assert int(windowed.adam.count) == 6 and len(ys["psnr"]) == 6

    np.testing.assert_allclose([float(x) for x in w_losses], [float(x) for x in j_losses],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose([float(x) for x in ys["psnr"]], np.asarray(j_ys["psnr"]),
                               rtol=2e-5)
    for k, p in windowed.model.param_dict().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j.model.parameters()[k])[:N],
                                   rtol=2e-4, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(windowed.xyz_grad_accum.numpy(),
                               np.asarray(j.xyz_grad_accum)[:N], rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(windowed.xyz_grad_denom.numpy(),
                                  np.asarray(j.xyz_grad_denom)[:N])


FLAGSHIP_RUN = dict(densify_from_iter=4, densify_until_iter=20, densify_interval=6,
                    densify_grad_threshold=2e-4, prune_from_iter=5, prune_until_iter=20,
                    prune_interval=7, box_size=3.0, importance_prune_from_iter=15,
                    importance_prune_until_iter=15, importance_prune_interval=15,
                    importance_prune_thr_important_score=1e9, cull_at_steps=[17],
                    opacity_reset_interval=11, opacity_reset_until_iter=11,
                    sh_degree_up_interval=5)
RUN_STEPS = 24
SAVE_AT = [9]


def _windows_of(trainer, model, record):
    """Wrap ``trainer``'s step and step_many: each call appends (first
    step, steps) to ``record`` and N to it after each of its steps."""
    take_step, take_many = trainer.step, trainer.step_many

    def step(camera):
        out = take_step(camera)
        record.append((trainer.curr_step, 1, model.num_points))
        return out

    def step_many(cameras):
        n0 = model.num_points
        out = take_many(cameras)
        record.append((trainer.curr_step - len(cameras) + 1, len(cameras), n0, model.num_points))
        return out

    trainer.step, trainer.step_many = step, step_many


def test_training_windows_equal_single_steps_and_jax(scene, tmp_path, monkeypatch):
    """The flagship toy run in windows of 16 and of 1: equal losses, N after
    every step (a window's N is its start's until its last step) and PLYs;
    the windows are the JAX loop's, driven with its steps stubbed."""
    cams8 = views_np(8, 24, 32)
    gt = torch_model(scene["params"], scene["degrees"])
    with torch.no_grad():
        images = [torch.clamp(gt.render(c)["render"], 0, 1).numpy()
                  for c in torch_dataset(cams8)]
    runs = {}
    for window in ("16", "1"):
        monkeypatch.setenv("R3DGS_WINDOW", window)
        tds = torch_dataset(cams8, images)
        model = torch_model(scene["start"], scene["degrees"])
        trainer = tprepare.prepare_trainer(model, tds, "densify-pruning-shculling",
                                           configs=FLAGSHIP_RUN)[0]
        record = []
        _windows_of(trainer, model, record)
        out = tmp_path / window
        losses = ttrain.training(tds, model, trainer, None, str(out), iteration=RUN_STEPS,
                                 save_iterations=SAVE_AT, device="cpu", log_interval=5)
        n_steps = []
        for entry in record:
            n_steps += [entry[2]] * (entry[1] - 1) + [entry[-1]]
        runs[window] = dict(losses=[float(x) for x in losses], n=n_steps, record=record,
                            plys={s: open(out / "point_cloud" / f"iteration_{s}" /
                                          "point_cloud.ply", "rb").read()
                                  for s in SAVE_AT + [RUN_STEPS]})
    w, s = runs["16"], runs["1"]
    assert w["losses"] == s["losses"]
    assert w["n"] == s["n"] and len(w["n"]) == RUN_STEPS and w["n"][-1] != N
    assert w["plys"] == s["plys"]
    windows = [(e[0], e[1]) for e in w["record"]]
    assert max(k for _, k in windows) > 1

    # JAX's loop over the same chain, its steps stubbed to advance the count
    # (and the SH schedule) only.
    monkeypatch.setenv("R3DGS_WINDOW", "16")
    jds = jax_dataset(cams8)
    jm = jax_model(scene["start"], scene["degrees"])
    jtr = jprepare.prepare_trainer(jm, jds, "densify-pruning-shculling",
                                   configs=FLAGSHIP_RUN)[0]
    jax_windows = []

    def stub(k):
        jax_windows.append((jtr.curr_step + 1, k))
        jtr.engine.maybe_advance_schedules()
        jtr.engine.curr_step = jtr.curr_step + k
        return [jnp.float32(0.0)] * k

    monkeypatch.setattr(jtr, "step", lambda camera: (stub(1)[0], {}), raising=False)
    monkeypatch.setattr(jtr, "step_many", lambda cameras: (stub(len(cameras)), {}),
                        raising=False)
    jtrain.training(jds, jm, jtr, None, str(tmp_path / "jax"), iteration=RUN_STEPS,
                    save_iterations=SAVE_AT, device="cpu", log_interval=5)
    assert windows == jax_windows


# ----------------------------------------------------------- key buffer
# (overflow at these steps of the drain, the drain's largest entry count).
DRAINS = [((), 3000), ((5,), 7000), ((), 5000), ((), 5000), ((), 5000), ((), 5000),
          ((1,), 9000), ((63,), 9000), ((0, 30), 9000), ((), 4000)]


def test_key_buffer_policy_matches_jax(scene, monkeypatch):
    """Ten drains of 64 steps (shrink, grow, three drains of cooldown,
    shrink, three overflowing drains in a row, then the streak reset)
    through both engines' _note_overflow: the same sizes after every drain,
    and one persistent_overflow snapshot each, at the ninth."""
    import reduced_3dgs_torch.utils.debug as tdebug
    import reduced_3dgs_tpu.utils.debug as jdebug
    snapshots = []
    for package, module in (("port", tdebug), ("jax", jdebug)):
        monkeypatch.setattr(module, "trainer_snapshot",
                            lambda trainer, tag, camera, extra, p=package:
                            snapshots.append((p, tag, extra["num_rendered_max"])))
    params, degrees = random_cloud_np(33, 1000)
    cam = camera_np(96, 128)
    tcam, jcam = torch_dataset([cam])[0], jax_dataset([cam])[0]
    t = TBaseTrainer(torch_model(params, degrees), torch_dataset([cam]))
    j = JBaseTrainer(jax_model(params, degrees), jax_dataset([cam]))
    assert t.key_capacity == j.capacity
    assert t.key_buffer_for(tcam) == j.key_buffer_for(jcam)
    sizes = []
    for d, (flagged, rendered) in enumerate(DRAINS):
        for step in range(64):
            over = step in flagged
            count = rendered if step == 17 else rendered // 2
            t._note_overflow({"overflow": torch.tensor(over),
                              "num_rendered": torch.tensor(count)}, tcam)
            j._note_overflow({"overflow": jnp.bool_(over),
                              "num_rendered": jnp.int32(count)}, jcam)
        sizes.append((t.key_buffer_for(tcam), j.key_buffer_for(jcam)))
        assert snapshots == ([] if d < 8 else [("port", "persistent_overflow", 9000),
                                               ("jax", "persistent_overflow", 9000)]), d
    assert [a for a, _ in sizes] == [b for _, b in sizes]
    assert len(set(a for a, _ in sizes)) >= 4
    assert (t._overflow_streak, t._shrink_cooldown) == (j._overflow_streak,
                                                        j._shrink_cooldown)


# ------------------------------------------------------ single-step cases
@pytest.mark.parametrize("case", ["sizes", "fov", "ground_truth", "camera_trainer"])
def test_fallback_windows_take_single_steps(scene, case, monkeypatch):
    """Cameras of two sizes, of two FoVs (a captured step holds its
    tangents), cameras with and without a depth map, and a camera trainer:
    update_many runs one update per camera, and the window equals its
    single steps."""
    cams = list(scene["cams"][:3])
    images = list(scene["images"][:3])
    if case == "sizes":
        cams[1] = camera_np(32, 48)
        images[1] = images[1][:, :32, :48]
    if case == "fov":
        cams[1] = camera_np(*HW, fovx=math.radians(50))
    tds = torch_dataset(cams, images)
    if case == "ground_truth":
        tds[1].ground_truth_depth = torch.ones(cams[1]["height"], cams[1]["width"])

    def trainer():
        base = TBaseTrainer(torch_model(scene["start"], scene["degrees"]), tds)
        return CameraTrainer(base, tds) if case == "camera_trainer" else base

    single, windowed = trainer(), trainer()
    calls = []
    update = type(windowed.engine).update

    def counted(engine, outer, camera):
        calls.append(camera)
        return update(engine, outer, camera)

    monkeypatch.setattr(windowed.engine, "update", counted.__get__(windowed.engine))
    s_losses = [single.step(c)[0] for c in tds]
    w_losses, ys = windowed.step_many(list(tds))
    assert calls == list(tds)
    assert [float(x) for x in w_losses] == [float(x) for x in s_losses]
    assert len(ys["psnr"]) == len(tds)
    for k, p in single.model.param_dict().items():
        assert torch.equal(windowed.model.param_dict()[k], p), k
