"""PyTorch port vs JAX package: one densification event, in isolation.

Both packages' engines hold the same state (80 Gaussians of mixed SH
degrees, and seeded densification statistics and Adam moments), and a
densifier chain fires once at step 10:

  * ``SplitCloneDensifier``: the clone and split masks, the split copies'
    positions and scales (the port fed the JAX draw
    ``jax.random.normal(fold_in(PRNGKey(0), step), (C, k, 3))[:n]``, C the
    JAX engine's capacity) and, after ``apply_instruction``, every
    per-Gaussian tensor with its rows in JAX's order: the kept rows, the
    clones in source order, then the split copies, k in a row;
  * ``DensificationDensifierWrapper`` over an ``ImportancePruner`` whose
    sweep returns a fixed mask: the importance mask, the appends and the
    opacity/size mask in one instruction.

The thresholds are held to a margin first (no score within 1e-5, relative,
of its threshold), then the masks and the row count compared exactly and
the values at rtol 1e-6. The port's own draw is checked by its
distribution only."""
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import importance as timportance  # noqa: E402
from reduced_3dgs_torch import trainer as ttrainer  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.models import GaussianModel as TGaussianModel  # noqa: E402
from reduced_3dgs_torch.trainer.densifier.split_clone import build_rotation  # noqa: E402
from reduced_3dgs_tpu import importance as jimportance  # noqa: E402
from reduced_3dgs_tpu import trainer as jtrainer  # noqa: E402
from reduced_3dgs_tpu.importance import trainer as jimp  # noqa: E402
from reduced_3dgs_tpu.trainer.densifier import SplitCloneDensifier as JSplitClone  # noqa: E402
from reduced_3dgs_tpu.trainer.densifier.split_clone import _build_rotation_jnp  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  random_cloud_np, torch_dataset, torch_model, views_np)

N = 80
STEP = 10
EXTENT = 1.0
SPLIT_CONFIG = dict(densify_from_iter=STEP, densify_until_iter=STEP, densify_interval=STEP,
                    densify_grad_threshold=2e-4, densify_percent_dense=0.04)
PRUNE_CONFIG = dict(prune_from_iter=STEP, prune_until_iter=STEP, prune_interval=STEP,
                    prune_big_from_iter=STEP - 1, prune_opacity_threshold=0.3,
                    prune_screensize_threshold=6.5, prune_percent_too_big=0.75,
                    scene_extent=EXTENT)


def _state(seed):
    """Seeded densification statistics and Adam moments of N rows."""
    rng = np.random.default_rng(seed)
    denom = rng.integers(0, 4, N).astype(np.int32)
    accum = (rng.uniform(0.0, 4e-4, N) * denom).astype(np.float32)
    radii = rng.integers(0, 10, N).astype(np.float32)
    moments = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in random_cloud_np(seed, N)[0].items()}
    return accum, denom, radii, moments


def _engines(densifier_jax, densifier_port, seed=91):
    """(JAX DensificationTrainer, port DensificationTrainer) over the same
    model and state, with the given densifier constructors."""
    params, degrees = random_cloud_np(seed, N, scale_lo=-4.5, scale_hi=-2.0)
    cams = views_np(3, 40, 56)
    accum, denom, radii, moments = _state(seed + 1)

    jm = jax_model(params, degrees)
    jds = jax_dataset(cams)
    jtr = jtrainer.DensificationTrainer(jtrainer.BaseTrainer(jm, jds), densifier_jax(jm, jds))
    engine = jtr.engine
    c = engine.capacity

    def pad(a):
        out = np.zeros((c,) + a.shape[1:], a.dtype)
        out[:N] = a
        return jnp.asarray(out)

    trees = engine.state_trees()
    trees["accum"] = {"xyz_grad_accum": pad(accum), "denom": pad(denom),
                      "max_radii2d": pad(radii)}
    trees["adam_m"] = {k: pad(v) for k, v in moments.items()}
    trees["adam_v"] = {k: pad(v * v) for k, v in moments.items()}
    engine.set_state_trees(trees, N)

    tm = torch_model(params, degrees)
    tds = torch_dataset(cams)
    ttr = ttrainer.DensificationTrainer(ttrainer.BaseTrainer(tm, tds), densifier_port(tm, tds))
    te = ttr.engine
    te.xyz_grad_accum = torch.from_numpy(accum.copy())
    te.xyz_grad_denom = torch.from_numpy(denom.copy())
    te.max_radii2d = torch.from_numpy(radii.copy())
    te.adam.m = {k: torch.from_numpy(v.copy()) for k, v in moments.items()}
    te.adam.v = {k: torch.from_numpy(v * v) for k, v in moments.items()}
    grads = np.where(denom > 0, accum / np.maximum(denom, 1), 0.0)
    return jtr, ttr, dict(params=params, degrees=degrees, grads=grads, radii=radii, capacity=c)


def _jax_draw(capacity, k):
    key = jax.random.fold_in(jax.random.PRNGKey(0), STEP)
    return torch.from_numpy(np.array(jax.random.normal(key, (capacity, k, 3)))[:N])


def _assert_state_matches(jtr, ttr, rtol=1e-6):
    n = int(jtr.engine.n_alive)
    assert ttr.model.num_points == n
    j = {g: {k: np.asarray(v)[:n] for k, v in t.items()}
         for g, t in jtr.engine.state_trees().items()}
    for group, tree in ttr.engine.state_trees().items():
        assert set(tree) == set(j[group]), group
        for name, v in tree.items():
            np.testing.assert_allclose(v.numpy(), j[group][name], rtol=rtol, atol=1e-7,
                                       err_msg=f"{group}/{name}")


def _split_jax(k):
    return lambda m, ds: JSplitClone(
        jtrainer.NoopDensifier(m), EXTENT, densify_n_split=k, **SPLIT_CONFIG)


def _split_port(k):
    return lambda m, ds: ttrainer.SplitCloneDensifier(
        ttrainer.NoopDensifier(m), EXTENT, densify_n_split=k, **SPLIT_CONFIG)


@pytest.mark.parametrize("k", [2, 3])
def test_split_clone_event_matches_jax(k):
    jtr, ttr, s = _engines(_split_jax(k), _split_port(k))
    limit = SPLIT_CONFIG["densify_percent_dense"] * EXTENT
    max_scaling = np.exp(s["params"]["scaling"]).max(axis=1)
    assert_decision_margin(s["grads"], SPLIT_CONFIG["densify_grad_threshold"])
    assert_decision_margin(max_scaling, limit)

    j_ins = jtr.densifier.densify_and_prune(None, None, None, STEP)
    samples = _jax_draw(s["capacity"], k)
    t_ins = ttr.densifier.densify_and_prune(None, None, None, STEP, samples=samples)
    (j_clone, j_split), (t_clone, t_split) = j_ins.appends, t_ins.appends
    assert (t_clone.copies, t_split.copies) == (j_clone.copies, j_split.copies) == (1, k)
    for tsp, jsp in ((t_clone, j_clone), (t_split, j_split)):
        np.testing.assert_array_equal(tsp.select.numpy(), np.asarray(jsp.select)[:N])
    hot = s["grads"] >= SPLIT_CONFIG["densify_grad_threshold"]
    np.testing.assert_array_equal(t_clone.select.numpy(), hot & (max_scaling <= limit))
    assert int(t_clone.select.sum()) > 0 and int(t_split.select.sum()) > 0
    np.testing.assert_array_equal(t_ins.remove_mask.numpy(), t_split.select.numpy())
    sel = t_split.select.numpy()
    for name in ("xyz", "scaling", "rotation", "features_rest"):
        np.testing.assert_allclose(t_split.values[name].numpy()[sel],
                                   np.asarray(j_split.values[name])[:N][sel],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    for engine in (ttr.engine, jtr.engine):
        assert not np.asarray(engine.xyz_grad_denom).any()

    jtr.apply_instruction(j_ins)
    ttr.apply_instruction(t_ins)
    n_clone, n_split = int(t_clone.select.sum()), int(t_split.select.sum())
    assert ttr.model.num_points == N + n_clone + (k - 1) * n_split
    _assert_state_matches(jtr, ttr)
    # The port's rows: kept sources, clones in source order, split copies.
    t = ttr.engine.state_trees()
    keep = ~sel
    n_keep = int(keep.sum())
    xyz = t["params"]["xyz"].numpy()
    np.testing.assert_array_equal(xyz[:n_keep], s["params"]["xyz"][keep])
    np.testing.assert_array_equal(xyz[n_keep:n_keep + n_clone],
                                  s["params"]["xyz"][t_clone.select.numpy()])
    np.testing.assert_array_equal(t["params"]["opacity"].numpy()[n_keep + n_clone:],
                                  np.repeat(s["params"]["opacity"][sel], k, axis=0))
    degrees = t["aux"]["degrees"].numpy()
    np.testing.assert_array_equal(degrees[:n_keep], s["degrees"][keep])
    assert (degrees[n_keep:] == 3).all()
    for group in ("adam_m", "adam_v"):
        assert all(not v[n_keep:].any() and v[:n_keep].any() for v in t[group].values())


def test_combined_instruction_matches_jax(monkeypatch):
    """Importance mask, clone/split appends and the opacity/size mask in one
    event: DensificationDensifierWrapper(partial(ImportancePruningDensifierWrapper,
    noop)) with the importance sweep replaced by a fixed mask."""
    fixed = np.random.default_rng(93).uniform(size=N) < 0.15
    monkeypatch.setattr(jimp, "prune_gaussians", lambda *a, **kw: jnp.asarray(fixed))
    monkeypatch.setattr(timp, "prune_gaussians", lambda *a, **kw: torch.from_numpy(fixed))
    imp = dict(importance_prune_from_iter=STEP, importance_prune_until_iter=STEP,
               importance_prune_interval=STEP)
    config = dict(SPLIT_CONFIG, **PRUNE_CONFIG, **imp)

    def noop_jax(m, ds, **cfg):
        return jtrainer.NoopDensifier(m)

    def noop_port(m, ds, **cfg):
        return ttrainer.NoopDensifier(m)

    jtr, ttr, s = _engines(
        lambda m, ds: jtrainer.DensificationDensifierWrapper(
            partial(jimportance.ImportancePruningDensifierWrapper, noop_jax), m, ds, **config),
        lambda m, ds: ttrainer.DensificationDensifierWrapper(
            partial(timportance.ImportancePruningDensifierWrapper, noop_port), m, ds,
            **config))
    # The JAX split draws at the JAX engine's capacity; feed the port that.
    split = ttr.densifier.base_densifier
    split.draw_samples = lambda n, step: _jax_draw(s["capacity"], 2)
    opacity = 1.0 / (1.0 + np.exp(-s["params"]["opacity"][:, 0]))
    max_scaling = np.exp(s["params"]["scaling"]).max(axis=1)
    assert_decision_margin(s["grads"], SPLIT_CONFIG["densify_grad_threshold"])
    assert_decision_margin(max_scaling, SPLIT_CONFIG["densify_percent_dense"] * EXTENT)
    assert_decision_margin(opacity, PRUNE_CONFIG["prune_opacity_threshold"])
    assert_decision_margin(max_scaling, 0.1 * PRUNE_CONFIG["prune_percent_too_big"])

    j_ins = jtr.densifier.densify_and_prune(None, None, None, STEP)
    t_ins = ttr.densifier.densify_and_prune(None, None, None, STEP)
    np.testing.assert_array_equal(t_ins.remove_mask.numpy(), np.asarray(j_ins.remove_mask)[:N])
    split_sel = t_ins.appends[1].select.numpy()
    opacity_mask = ((opacity < PRUNE_CONFIG["prune_opacity_threshold"])
                    | (max_scaling > 0.1 * PRUNE_CONFIG["prune_percent_too_big"]))
    # Radii are zeroed by the split before the size prune reads them.
    np.testing.assert_array_equal(t_ins.remove_mask.numpy(), fixed | split_sel | opacity_mask)
    for only in (fixed & ~split_sel & ~opacity_mask, opacity_mask & ~split_sel & ~fixed):
        assert only.any()
    assert (s["radii"] > PRUNE_CONFIG["prune_screensize_threshold"]).any()
    jtr.apply_instruction(j_ins)
    ttr.apply_instruction(t_ins)
    n_clone = int(t_ins.appends[0].select.sum())
    assert ttr.model.num_points == (N - int(t_ins.remove_mask.sum()) + n_clone
                                    + 2 * int(split_sel.sum()))
    _assert_state_matches(jtr, ttr)


def test_port_draw_is_seeded_per_step_and_standard_normal():
    model = TGaussianModel(3, device="cpu")
    model.load_numpy({k: v for k, v in random_cloud_np(95, 4)[0].items()})
    split = ttrainer.SplitCloneDensifier(ttrainer.NoopDensifier(model), 1.0, seed=7)
    a = split.draw_samples(20_000, 100)
    assert a.shape == (20_000, 2, 3) and a.device == model._xyz.device
    assert torch.equal(a, split.draw_samples(20_000, 100))
    assert not torch.equal(a, split.draw_samples(20_000, 200))
    other = ttrainer.SplitCloneDensifier(ttrainer.NoopDensifier(model), 1.0, seed=8)
    assert not torch.equal(a, other.draw_samples(20_000, 100))
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1.0) < 0.02


def test_build_rotation_matches_jax():
    q = np.random.default_rng(96).normal(size=(16, 4)).astype(np.float32)
    q[0] = 0.0
    q[1] *= 1e-7
    np.testing.assert_allclose(build_rotation(torch.from_numpy(q)).numpy(),
                               np.asarray(_build_rotation_jnp(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)


def test_aux_for_new_points():
    params, degrees = random_cloud_np(97, 3)
    assert TGaussianModel(3, device="cpu").aux_for_new_points(4) == {}
    new = torch_model(params, degrees).aux_for_new_points(4)["degrees"]
    assert new.dtype == torch.int32 and new.tolist() == [3, 3, 3, 3]
    np.testing.assert_array_equal(new.numpy(),
                                  np.asarray(jax_model(params, degrees).aux_for_new_points(4)
                                             ["degrees"]))
