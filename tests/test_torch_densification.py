"""PyTorch port vs JAX package: the densification trainer.

The remove path: a densifier that removes a fixed set of rows after step 2
drives both packages' ``DensificationTrainer`` over a ``BaseTrainer`` for
three steps on a toy scene (80 Gaussians of mixed SH degrees, three 40x56
views, the JAX model on its XLA tiled path). Afterwards the port's
parameters, Adam moments, densification statistics and degrees must equal
the JAX engine's live rows at the trainer tests' bars (rtol 1e-3), the row count and
degrees exactly, and the port's state after the removal must be exactly its
state before it, cut to the kept rows in order.

The whole densification path: ``OpacityResetDensificationTrainer`` of both
packages trains the same toy scene for 8 steps, camera 0 with a
ground-truth depth map. Split and clone fire after steps 2, 4 and 6, the
opacity/size prune after steps 3 and 6 (6 coincides with a split, so the
screen-size criterion reads zeroed radii), the opacity reset after step 7.
The port's split is fed the JAX package's draw. N after every step and the
degrees must agree exactly, the losses at rtol 1e-4, and the parameters,
Adam moments and statistics at rtol 1e-3. Each decision is held to a margin
first."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import trainer as ttrainer  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import common  # noqa: E402
from reduced_3dgs_tpu import trainer as jtrainer  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  random_cloud_np, torch_dataset, torch_model, views_np)

N = 80
REMOVE_AT = 2
STEPS = 3


def toy_scene(seed=71, n=N, views=3, hw=(40, 56), with_depth=False):
    """(perturbed params, degrees, camera dicts, ground-truth images), and
    with ``with_depth`` the ground-truth depths: the images and depths are
    the JAX package's renders of the unperturbed scene, the depth
    depth / (1 - final_T), 0 where final_T > 0.5."""
    params, degrees = random_cloud_np(seed, n, spread=0.9)
    cams = views_np(views, *hw)
    gt_model = jax_model(params, degrees)
    outs = [gt_model(cam) for cam in jax_dataset(cams)]
    images = [np.clip(np.asarray(o["render"]), 0, 1) for o in outs]
    rng = np.random.default_rng(seed + 1)
    sigma = dict(xyz=0.01, features_dc=0.05, features_rest=0.02, scaling=0.1,
                 rotation=0.02, opacity=0.2)
    perturbed = {k: (v + sigma[k] * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
    if not with_depth:
        return perturbed, degrees, cams, images
    depths = []
    for o in outs:
        t = np.asarray(o["final_T"])
        depths.append(np.where(t > 0.5, 0.0, np.asarray(o["depth"]) / np.maximum(1.0 - t, 1e-6))
                      .astype(np.float32))
    return perturbed, degrees, cams, images, depths


class _JaxRemover(jtrainer.AbstractDensifier):
    def __init__(self, model, mask):
        super().__init__(model)
        self.mask = mask

    def densify_and_prune(self, loss, out, camera, step):
        if step != REMOVE_AT:
            return jtrainer.DensificationInstruction()
        return jtrainer.DensificationInstruction(remove_mask=jnp.asarray(self.mask))


class _PortRemover(ttrainer.AbstractDensifier):
    """Removes ``mask`` after step REMOVE_AT, with a copy of the engine's
    state just before."""

    def __init__(self, model, mask):
        super().__init__(model)
        self.mask = mask

    def densify_and_prune(self, loss, out, camera, step):
        if step != REMOVE_AT:
            return ttrainer.DensificationInstruction()
        self.before = {g: {k: v.clone() for k, v in t.items()}
                       for g, t in self.trainer.engine.state_trees().items()}
        assert not loss.requires_grad and not out["render"].requires_grad
        return ttrainer.DensificationInstruction(remove_mask=torch.from_numpy(self.mask))


@pytest.fixture(scope="module")
def removed():
    params, degrees, cams, images = toy_scene()
    mask = np.random.default_rng(72).uniform(size=N) < 0.3
    jm = jax_model(params, degrees)
    jds = jax_dataset(cams, images)
    jtr = jtrainer.DensificationTrainer(jtrainer.BaseTrainer(jm, jds), _JaxRemover(jm, mask))
    tm = torch_model(params, degrees)
    tds = torch_dataset(cams, images)
    remover = _PortRemover(tm, mask)
    ttr = ttrainer.DensificationTrainer(ttrainer.BaseTrainer(tm, tds), remover)
    j_losses, t_losses = [], []
    for it in range(STEPS):
        j_losses.append(float(jtr.step(jds[it % 3])[0]))
        t_losses.append(float(ttr.step(tds[it % 3])[0]))
    return dict(mask=mask, degrees=degrees, jtr=jtr, ttr=ttr, remover=remover,
                j_losses=j_losses, t_losses=t_losses)


def _jax_live(jtr):
    n = int(jtr.engine.n_alive)
    trees = jtr.engine.state_trees()
    return n, {g: {k: np.asarray(v)[:n] for k, v in t.items()} for g, t in trees.items()}


def test_remove_path_matches_jax_live_rows(removed):
    n, j = _jax_live(removed["jtr"])
    engine = removed["ttr"].engine
    keep = ~removed["mask"]
    assert engine.model.num_points == n == keep.sum() < N
    np.testing.assert_allclose(removed["t_losses"], removed["j_losses"], rtol=1e-4)
    t = engine.state_trees()
    np.testing.assert_array_equal(t["aux"]["degrees"].numpy(), removed["degrees"][keep])
    np.testing.assert_array_equal(t["aux"]["degrees"].numpy(), j["aux"]["degrees"])
    for group in ("params", "adam_m", "adam_v", "accum"):
        for k, v in t[group].items():
            jv = j[group][k]
            assert v.shape == jv.shape, (group, k)
            np.testing.assert_allclose(v.numpy(), jv, rtol=1e-3, atol=1e-6 * np.abs(jv).max(),
                                       err_msg=f"{group}/{k}")
    assert engine.adam.count == int(removed["jtr"].engine.adam.count) == STEPS


def test_removal_is_a_stable_row_selection(removed):
    """After the removal step the port's state is exactly its state just
    before, cut to the kept rows in order; the model's parameters are new
    ``nn.Parameter``s of the new size, and Adam's step count is kept."""
    remover = removed["remover"]
    keep = torch.from_numpy(~removed["mask"])
    params, degrees, cams, images = toy_scene()
    tm = torch_model(params, degrees)
    tds = torch_dataset(cams, images)
    rem = _PortRemover(tm, removed["mask"])
    ttr = ttrainer.DensificationTrainer(ttrainer.BaseTrainer(tm, tds), rem)
    for it in range(REMOVE_AT):
        ttr.step(tds[it % 3])
    after = ttr.engine.state_trees()
    for group, tree in rem.before.items():
        for k, v in tree.items():
            assert torch.equal(after[group][k], v[keep]), (group, k)
    for p in tm.param_dict().values():
        assert isinstance(p, torch.nn.Parameter) and p.requires_grad
        assert p.shape[0] == int(keep.sum())
    assert ttr.engine.adam.count == REMOVE_AT
    assert remover.before["params"]["xyz"].shape[0] == N


def test_instruction_merge_and_unported_additions():
    """Merging removal masks, and an instruction that removes and appends in
    one event: the kept rows in order, then the new rows with zero Adam
    moments and statistics and the maximum degree; an empty instruction
    changes nothing."""
    a = ttrainer.DensificationInstruction()
    m1 = torch.tensor([True, False, False])
    m2 = torch.tensor([False, False, True])
    assert a.merge_remove(None) is a
    assert torch.equal(a.merge_remove(m1).merge_remove(m2).remove_mask,
                       torch.tensor([True, False, True]))
    params, degrees = random_cloud_np(73, 5)
    tm = torch_model(params, degrees)
    ttr = ttrainer.DensificationTrainer(ttrainer.BaseTrainer(tm, None),
                                        ttrainer.NoopDensifier(tm))
    assert ttr.densifier.trainer is ttr and ttr.engine._last_step_io_engine is None
    ttr.apply_instruction(ttrainer.DensificationInstruction())
    assert tm.num_points == 5
    for v in ttr.engine.adam.m.values():
        v.fill_(1.0)
    ttr.engine.xyz_grad_denom.fill_(2)
    new, _ = random_cloud_np(74, 2)
    remove = torch.tensor([False, True, False, False, True])
    ttr.apply_instruction(ttrainer.DensificationInstruction(new_points=new, remove_mask=remove))
    t = ttr.engine.state_trees()
    for k, v in t["params"].items():
        np.testing.assert_array_equal(v.numpy(), np.concatenate([params[k][[0, 2, 3]], new[k]]))
    np.testing.assert_array_equal(t["aux"]["degrees"].numpy(), list(degrees[[0, 2, 3]]) + [3, 3])
    assert all(bool((v[:3] == 1).all()) and not v[3:].any() for v in t["adam_m"].values())
    assert t["accum"]["denom"].tolist() == [2, 2, 2, 0, 0]
    assert all(v.shape[0] == 5 for g in t.values() for v in g.values())


# ------------------------------------------------ the whole densification path
RUN_STEPS = 8
SPLIT_STEPS, PRUNE_STEPS, RESET_STEP = (2, 4, 6), (3, 6), 7
RUN_CONFIG = dict(
    # A position rate 100x the default moves a clone away from its source by
    # about 1e-3 in its first step, far more than the last bits in which the
    # packages' view depths differ; near-twins would otherwise sort in
    # opposite orders (see test_densification_run_decisions_have_margins).
    sh_degree_up_interval=2, position_lr_init=0.016, position_lr_final=0.00016,
    densify_from_iter=2, densify_until_iter=6, densify_interval=2,
    densify_grad_threshold=0.02, densify_percent_dense=0.7,
    # The pruner's own scene extent sets the world-size bar to 0.08.
    prune_from_iter=3, prune_until_iter=6, prune_interval=3, prune_big_from_iter=2,
    prune_opacity_threshold=0.3, prune_screensize_threshold=4.5, prune_percent_too_big=0.8,
    scene_extent=1.0,
    opacity_reset_interval=RESET_STEP, opacity_reset_until_iter=RESET_STEP,
    opacity_reset_value=0.01, depth_l1_weight_max_steps=10)


def _jax_draw(capacity, step, n, k):
    """The JAX split's normal samples of the event at ``step``, rows [:n]."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return torch.from_numpy(np.array(jax.random.normal(key, (capacity, k, 3)))[:n])


def _split_and_pruner(trainer):
    """The SplitCloneDensifier and OpacityPruner of an
    OpacityResetDensificationTrainer."""
    pruner = trainer.base_trainer.base_trainer.densifier
    return pruner.base_densifier, pruner


@pytest.fixture(scope="module")
def run():
    params, degrees, cams, images, depths = toy_scene(with_depth=True)
    depths = [depths[0], None, None]

    # JAX, step by step, with the capacity its split draws at.
    jm = jax_model(params, degrees)
    jds = jax_dataset(cams, images, depths)
    jtr = jtrainer.OpacityResetDensificationTrainer(jm, jds, **RUN_CONFIG)
    j_split, _ = _split_and_pruner(jtr)
    capacity = {}
    j_split_fn = j_split.densify_and_prune

    def j_record(loss, out, camera, step):
        capacity[step] = j_split.trainer.engine.model.parameters()["xyz"].shape[0]
        return j_split_fn(loss, out, camera, step)

    j_split.densify_and_prune = j_record
    j_losses, j_n, j_deg = [], [], {}
    for it in range(RUN_STEPS):
        j_losses.append(float(jtr.step(jds[it % 3])[0]))
        j_n.append(jm.num_points)
        j_deg[it + 1] = np.asarray(jm.aux_state()["degrees"])[:jm.num_points]

    # The port, fed the JAX draw, with each decision's inputs recorded.
    tm = torch_model(params, degrees)
    tds = torch_dataset(cams, images, depths)
    ttr = ttrainer.OpacityResetDensificationTrainer(tm, tds, **RUN_CONFIG)
    t_split, t_pruner = _split_and_pruner(ttr)
    k = t_split.densify_n_split
    t_split.draw_samples = lambda n, step: _jax_draw(capacity[step], step, n, k)
    rec = {"split": {}, "prune": {}, "instruction": {}, "state": {}}
    t_split_fn, t_prune_fn, t_apply = t_split.densify_and_prune, t_pruner.prune, \
        ttr.base_trainer.base_trainer.apply_instruction

    def t_record_split(loss, out, camera, step):
        if t_split.fires(step):
            e = ttr.engine
            rec["split"][step] = (e.xyz_grad_accum.clone(), e.xyz_grad_denom.clone(),
                                  torch.exp(tm._scaling.detach()).max(dim=1).values)
        return t_split_fn(loss, out, camera, step)

    def t_record_prune():
        e = ttr.engine
        rec["prune"][ttr.curr_step] = (torch.sigmoid(tm._opacity.detach()[:, 0]),
                                       e.max_radii2d.clone(),
                                       torch.exp(tm._scaling.detach()).max(dim=1).values)
        return t_prune_fn()

    def t_record_apply(instruction):
        rec["instruction"][ttr.curr_step] = (tm.num_points, instruction)
        return t_apply(instruction)

    t_split.densify_and_prune = t_record_split
    t_pruner.prune = t_record_prune
    ttr.base_trainer.base_trainer.apply_instruction = t_record_apply
    t_losses, t_n, rec["depth"] = [], [], []
    for it in range(RUN_STEPS):
        with torch.no_grad():
            pre = common.preprocess(*tm.render_array_args(), tm.render_settings(tds[it % 3]))
        rec["depth"].append((pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched > 0))
        t_losses.append(float(ttr.step(tds[it % 3])[0]))
        t_n.append(tm.num_points)
        rec["state"][it + 1] = {g: {kk: v.clone() for kk, v in t.items()}
                                for g, t in ttr.engine.state_trees().items()}
    return dict(jtr=jtr, ttr=ttr, j_losses=j_losses, t_losses=t_losses, j_n=j_n, t_n=t_n,
                j_deg=j_deg, rec=rec, degrees=degrees, k=k)


def test_densification_run_decisions_have_margins(run):
    """The thresholds of the split and the prune, and the depth order of
    every two Gaussians that share a tile at every render: their view depths
    are equal (a clone in its first render, ordered by row in both packages)
    or differ by more than 1e-6 (relative), some eight float32 ulps, so that
    the packages' last-bit differences cannot swap them."""
    rec, split = run["rec"], _split_and_pruner(run["ttr"])[0]
    for depths, rect_min, rect_max, seen in rec["depth"]:
        d, lo, hi = depths[seen].double(), rect_min[seen], rect_max[seen]
        share = ((torch.maximum(lo[:, None], lo[None]) < torch.minimum(hi[:, None], hi[None]))
                 .all(dim=-1))
        gap = (d[:, None] - d[None]).abs()
        near = share & (gap > 0) & (gap <= 1e-6 * d.abs().max())
        assert not near.any(), gap[near]
    assert sorted(rec["split"]) == list(SPLIT_STEPS) and sorted(rec["prune"]) == list(PRUNE_STEPS)
    for accum, denom, max_scaling in rec["split"].values():
        grads = torch.where(denom > 0, accum / torch.clamp(denom, min=1), 0.0)
        assert_decision_margin(grads.numpy(), RUN_CONFIG["densify_grad_threshold"])
        assert_decision_margin(max_scaling.numpy(), split.densify_percent_dense * split.scene_extent)
    for opacity, radii, max_scaling in rec["prune"].values():
        assert_decision_margin(opacity.numpy(), RUN_CONFIG["prune_opacity_threshold"])
        assert_decision_margin(radii.numpy(), RUN_CONFIG["prune_screensize_threshold"])
        assert_decision_margin(max_scaling.numpy(), 0.1 * RUN_CONFIG["prune_percent_too_big"])


def test_densification_run_events(run):
    """Every kind of event happens: clones and splits at each densify step,
    prunes by opacity and by size, a step where split and prune coincide
    (the prune reads zeroed radii there), and the opacity reset."""
    rec, k = run["rec"], run["k"]
    counts = {}
    for step, (n, ins) in rec["instruction"].items():
        clone, split = (ins.appends[0].select, ins.appends[1].select) if ins.appends else (None, None)
        if step in SPLIT_STEPS:
            assert clone.shape == split.shape == (n,)
            assert int(clone.sum()) > 0 and int(split.sum()) > 0 and not (clone & split).any()
        removed = 0 if ins.remove_mask is None else int(ins.remove_mask.sum())
        added = (int(clone.sum()) + k * int(split.sum())) if ins.appends else 0
        assert run["t_n"][step - 1] == n - removed + added
        counts[step] = (removed, added)
    assert counts[3][0] > 0 and counts[3][1] == 0
    opacity, radii, _ = rec["prune"][3]
    assert (opacity < RUN_CONFIG["prune_opacity_threshold"]).any()
    assert (radii > RUN_CONFIG["prune_screensize_threshold"]).any()
    assert not rec["prune"][6][1].any()                   # zeroed by the split first
    for step in SPLIT_STEPS:
        new = run["t_n"][step - 1] - (rec["instruction"][step][0] - counts[step][0])
        state = rec["state"][step]
        assert (state["aux"]["degrees"][-new:] == 3).all()
        for group in ("adam_m", "adam_v"):
            assert all(not v[-new:].any() for v in state[group].values())
        assert all(not v.any() for v in state["accum"].values())
    reset = rec["state"][RESET_STEP]
    assert float(torch.sigmoid(reset["params"]["opacity"]).max()) <= 0.01 * (1 + 1e-6)
    assert not reset["adam_m"]["opacity"].any() and not reset["adam_v"]["opacity"].any()
    assert reset["adam_m"]["xyz"].any()
    assert run["ttr"].engine.adam.count == RUN_STEPS


def test_densification_run_row_counts_and_degrees_match_jax(run):
    assert run["t_n"] == run["j_n"]
    assert run["t_n"][1] > N
    for step, deg in run["j_deg"].items():
        np.testing.assert_array_equal(run["rec"]["state"][step]["aux"]["degrees"].numpy(), deg,
                                      err_msg=f"step {step}")


def test_densification_run_losses_and_state_match_jax(run):
    np.testing.assert_allclose(run["t_losses"], run["j_losses"], rtol=1e-4)
    n, j = _jax_live(run["jtr"])
    t = run["ttr"].engine.state_trees()
    for group in ("params", "adam_m", "adam_v", "accum"):
        for name, v in t[group].items():
            jv = j[group][name]
            assert v.shape == jv.shape, (group, name)
            np.testing.assert_allclose(v.numpy(), jv, rtol=1e-3, atol=1e-6 * np.abs(jv).max(),
                                       err_msg=f"{group}/{name}")
