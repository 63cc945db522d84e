"""PyTorch port vs JAX package: the one-program event sweeps.

More than one view of one image size and FoV sweep through the static key
buffer (the port's ``ops.rasterize.sweep.static_sweep``, JAX's
``_sweep_counts`` and ``sweep``); on the CPU the port's fixed-shape body
runs once per camera. Other views take the port's per-view loop.

  * ``prune_list`` against JAX's scan, with and without ``resize``: counts
    exact, scores within rtol 1e-5 and atol 1e-5 (tests/test_importance.py's
    bar for JAX's scan against its loop).
  * A forced overflow: from a key buffer a third of the largest view's
    entries, both packages regrow to the same K (the port writes it back to
    the engine), and the sums are the exact sweep's.
  * ``calculate_colours_variance`` on cameras of three FoVs (the port's
    loop) against JAX's ``sweep``, within rtol 1e-5 and atol 1e-6
    (tests/test_shculling.py's bar for JAX's scan against its loop), and
    the port's static sweep over views of one FoV against its own loop bit
    for bit.
  * The colour sweep at a key buffer that overflows: JAX's sweep reads no
    overflow flag and its result moves away from its own large-buffer
    result; the port regrows and keeps the large-buffer result.
  * ``cull_sh_bands`` through the sweep: degrees equal JAX's and the
    features within 1e-5 (after ``assert_decision_margin``), and the port's
    degrees and features bit for bit those of its loop.
  * Cameras that are not stackable, and the 2DGS model, take the loop.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.dataset import camera as tcamera  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.ops import shculling_stats as tstats  # noqa: E402
from reduced_3dgs_torch.shculling import cull_sh_bands as tcull  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer as TBaseTrainer  # noqa: E402
from reduced_3dgs_tpu.importance import trainer as jimp  # noqa: E402
from reduced_3dgs_tpu.ops import shculling_stats as jstats  # noqa: E402
from reduced_3dgs_tpu.shculling import cull_sh_bands as jcull  # noqa: E402
from reduced_3dgs_tpu.shculling import trainer as jtrainer  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, camera_np, jax_dataset,  # noqa: E402
                                  jax_model, random_cloud_np, rotation_y, torch_dataset,
                                  torch_model, views_np)
from .test_torch_shculling import _between  # noqa: E402

N = 90
HW = (48, 64)
RESIZE = 40


def _fov_views():
    """Three views of one size at three FoVs and three poses."""
    return [camera_np(*HW, fovx=math.radians(f), R=rotation_y(a),
                      T=np.array([0.04 * i, -0.02 * i, 0.03 * i], np.float32))
            for i, (f, a) in enumerate(((60.0, -0.06), (66.0, 0.0), (54.0, 0.07)))]


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(141, N, spread=0.9)
    return params, degrees, views_np(3, *HW)


@pytest.fixture
def spy(monkeypatch):
    """The kinds of the static sweeps run while the test runs."""
    kinds = []

    def recording(module, kind):
        run = module.static_sweep

        def sweep(*args, **kwargs):
            kinds.append(kind)
            return run(*args, **kwargs)
        monkeypatch.setattr(module, "static_sweep", sweep)

    recording(timp, "importance")
    recording(tstats, "colours")
    return kinds


def _engine(model, camera, key_buffer):
    engine = TBaseTrainer(model)
    engine.set_key_buffer(camera, key_buffer)
    return engine


def _assert_counts(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    for a, b, name in zip(t[1:], j[1:], ("opacity", "t_alpha")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("resize", [None, RESIZE])
def test_prune_list_matches_jax_scan(scene, spy, resize):
    params, degrees, cams = scene
    t = timp.prune_list(torch_model(params, degrees), torch_dataset(cams), resize)
    assert spy == ["importance"]
    j = jimp.prune_list(jax_model(params, degrees), jax_dataset(cams), resize)
    assert t[0].dtype == torch.int32 and t[0].shape == (N,) and int(t[0].sum()) > 0
    _assert_counts(t, j)


def test_forced_overflow_regrows_like_jax(scene, spy):
    params, degrees, cams = scene
    tm, tds = torch_model(params, degrees), torch_dataset(cams)
    with torch.no_grad():
        entries = max(int(tm.render(cam)["num_rendered"]) for cam in tds)
    start = entries // 3
    engine = _engine(tm, tds[0], start)
    t = timp.prune_list(tm, tds, engine=engine)
    jm = jax_model(params, degrees)
    jm._key_buffer_size = start
    j = jimp.prune_list(jm, jax_dataset(cams))
    regrown = engine.held_key_buffer(tds[0])
    assert spy == ["importance"]
    assert regrown == jm._key_buffer_size and regrown >= entries > regrown // 2 >= start
    _assert_counts(t, j)
    exact = timp.exact_counts(tm, tcamera.sweep_cameras(tds))
    assert torch.equal(t[0], exact[0])
    for a, b in zip(t[1:], exact[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def _colours(model, cams, params, degrees, engine=None):
    return tstats.calculate_colours_variance(
        cams, model, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(degrees), 3, **({} if engine is None else engine.sweep_buffer(cams[0])))


def test_colours_variance_across_fovs_matches_jax(scene, spy, monkeypatch):
    params, degrees, cams = scene
    fov_cams = _fov_views()
    tm = torch_model(params, degrees)
    t = _colours(tm, list(torch_dataset(fov_cams)), params, degrees)
    assert spy == []                    # three FoVs: the loop
    jm = jax_model(params, degrees)
    j = jstats.calculate_colours_variance(list(jax_dataset(fov_cams)), jm, jm.parameters(),
                                          jnp.asarray(degrees), 3)
    for name, a, b in zip(("avg_dist", "variance", "mean"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.asarray(j[1]).max() > 0 and np.asarray(j[0]).max() > 0
    tds = list(torch_dataset(cams))
    static = _colours(tm, tds, params, degrees)
    assert spy == ["colours"]
    monkeypatch.setattr(tcamera, "stackable", lambda cs: False)
    loop = _colours(tm, tds, params, degrees)
    assert spy == ["colours"]
    for a, b in zip(static, loop):
        assert torch.equal(a, b)


def test_colours_sweep_overflow_jax_truncates_port_regrows(scene, spy):
    params, degrees, cams = scene
    tm, tds = torch_model(params, degrees), torch_dataset(cams)
    with torch.no_grad():
        entries = max(int(tm.render(cam)["num_rendered"]) for cam in tds)
    start = entries // 3
    jd = jnp.asarray(degrees)
    j_large, j_small = jax_model(params, degrees), jax_model(params, degrees)
    j_small._key_buffer_size = start
    jlist = list(jax_dataset(cams))
    jl = jstats.calculate_colours_variance(jlist, j_large, j_large.parameters(), jd, 3)
    js = jstats.calculate_colours_variance(jlist, j_small, j_small.parameters(), jd, 3)
    # JAX: the truncated renders move the statistics, and nothing regrew.
    assert j_small._key_buffer_size == start
    assert max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(js, jl)) > 1e-3
    t_large = _colours(tm, list(tds), params, degrees)
    engine = _engine(tm, tds[0], start)
    t_small = _colours(tm, list(tds), params, degrees, engine=engine)
    assert spy == ["colours", "colours"]
    assert engine.held_key_buffer(tds[0]) >= entries
    for a, b in zip(t_small, t_large):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for name, a, b in zip(("avg_dist", "variance", "mean"), t_small, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_cull_sh_bands_through_the_sweep(scene, spy, monkeypatch):
    params, degrees, cams = scene
    jm, jds = jax_model(params, degrees), jax_dataset(cams)
    jd = jnp.asarray(degrees)
    _, var, mean = jstats.calculate_colours_variance(jds, jm, jm.parameters(), jd, 3)
    std = np.nan_to_num(np.sqrt(np.asarray(var))).mean(axis=2)[:, 0]
    std_threshold = _between(std)
    assert_decision_margin(std, std_threshold)
    d2, f_dc, f_rest = jtrainer._low_variance_colour_culling(
        jd, jm.parameters()["features_dc"], jm.parameters()["features_rest"], std_threshold,
        var, mean)
    p2 = dict(jm.parameters(), features_dc=f_dc, features_rest=f_rest)
    dist = np.asarray(jstats.calculate_colours_variance(jds, jm, p2, d2, 3)[0])
    cdist_threshold = _between(dist[:, 1])
    for band in (1, 2):
        assert_decision_margin(dist[:, band], cdist_threshold)

    jcull(jm, jds, cdist_threshold, std_threshold)
    tm, tds = torch_model(params, degrees), torch_dataset(cams)
    tcull(tm, tds, cdist_threshold, std_threshold)
    assert spy == ["colours", "colours"]
    j_deg = np.asarray(jm.aux_state()["degrees"])
    np.testing.assert_array_equal(tm._degrees.numpy(), j_deg)
    assert (j_deg == 0).sum() > (degrees == 0).sum()
    assert ((j_deg > 0) & (j_deg < degrees)).any()
    for name in ("features_dc", "features_rest"):
        np.testing.assert_allclose(tm.param_dict()[name].detach().numpy(),
                                   np.asarray(jm.parameters()[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    monkeypatch.setattr(tcamera, "stackable", lambda cs: False)
    loop = torch_model(params, degrees)
    tcull(loop, tds, cdist_threshold, std_threshold)
    assert spy == ["colours", "colours"]
    assert torch.equal(loop._degrees, tm._degrees)
    for name in ("features_dc", "features_rest"):
        assert torch.equal(loop.param_dict()[name], tm.param_dict()[name]), name


def test_non_stackable_cameras_and_2dgs_take_the_loop(scene, spy, monkeypatch):
    from reduced_3dgs_torch.shculling import VariableSHGsplat2DGSGaussianModel
    params, degrees, cams = scene
    mixed = cams[:2] + [camera_np(40, 56, R=cams[2]["R"], T=cams[2]["T"])]
    tm = torch_model(params, degrees)
    t = timp.prune_list(tm, torch_dataset(mixed))
    t_colours = _colours(tm, list(torch_dataset(mixed)), params, degrees)
    surfels = VariableSHGsplat2DGSGaussianModel(3, device="cpu").load_numpy(params, degrees)
    s = timp.prune_list(surfels, torch_dataset(cams))
    timp.prune_list(tm, torch_dataset(_fov_views()))      # one size, three FoVs
    assert spy == []
    assert not tcamera.stackable(tcamera.sweep_cameras(torch_dataset(mixed)))
    jm = jax_model(params, degrees)
    _assert_counts(t, jimp.prune_list(jm, jax_dataset(mixed)))
    j_colours = jstats.calculate_colours_variance(list(jax_dataset(mixed)), jm,
                                                  jm.parameters(), jnp.asarray(degrees), 3)
    for name, a, b in zip(("avg_dist", "variance", "mean"), t_colours, j_colours):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    per_camera = sum(timp.count_render(surfels, c)["gaussians_count"]
                     for c in torch_dataset(cams))
    assert torch.equal(s[0], per_camera)
    # The same-size views through the loop give the static sweep's sums.
    tds = torch_dataset(cams)
    static = timp.prune_list(tm, tds)
    monkeypatch.setattr(tcamera, "stackable", lambda cs: False)
    loop = timp.prune_list(tm, tds)
    assert spy == ["importance"]
    assert torch.equal(static[0], loop[0])
    for a, b in zip(static[1:], loop[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
