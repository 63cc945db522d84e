"""PyTorch port vs JAX package: the point-cloud start, the pruning
compositions and the flagship trainer.

  * ``create_from_pcd`` and ``colmap_init`` from a tiny COLMAP dataset, in
    text and in binary: parameters within 1e-6.
  * Every composition of ``pruning/combinations.py`` and
    ``combinations.py`` builds the JAX package's onion, class for class.
  * ``SHCullingOpacityResetFullReducedDensificationTrainer`` (the
    ``densify-pruning-shculling`` mode) trains the toy scene of
    tests/test_torch_densification.py (80 Gaussians, three 40x56 views, one
    with depth) for 12 steps in both packages: split and clone after step
    3, the opacity and mercy prune after step 5 (with a non-empty mercy
    mask), the importance prune after step 7, the SH cull after step 9, the
    opacity reset after step 10. The port's split is fed the JAX package's
    draw. N after every step and every removal mask must agree exactly, the
    losses at rtol 1e-4, and the state at rtol 1e-3. Each decision is held
    to a margin first; at 80-160 rows both packages' KNN sees every point,
    so their neighbours are exact."""
import math
import os
import struct

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import combinations as tcomb  # noqa: E402
from reduced_3dgs_torch import pruning as tpruning  # noqa: E402
from reduced_3dgs_torch.dataset.colmap import colmap_init as t_colmap_init  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.ops import knn as tk  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import common, twodgs  # noqa: E402
from reduced_3dgs_torch.pruning import trainer as tp  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGsplat2DGSGaussianModel  # noqa: E402
from reduced_3dgs_torch.shculling import trainer as tsh  # noqa: E402
from reduced_3dgs_tpu import combinations as jcomb  # noqa: E402
from reduced_3dgs_tpu import pruning as jpruning  # noqa: E402
from reduced_3dgs_tpu.dataset.colmap import colmap_init as j_colmap_init  # noqa: E402
from reduced_3dgs_tpu.pruning import trainer as jp  # noqa: E402
from reduced_3dgs_tpu.shculling import VariableSHGaussianModel as JModel  # noqa: E402

from .test_torch_densification import _jax_draw, _jax_live, toy_scene  # noqa: E402
from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  random_cloud_np, torch_dataset, torch_model)
from .test_torch_redundancy import Q_MARGIN, quadratic_forms  # noqa: E402

# ------------------------------------------------------------ COLMAP start
H, W = 24, 32
FOCAL = 30.0
POSES = [((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
         ((math.cos(0.05), 0.0, math.sin(0.05), 0.0), (0.3, 0.0, 0.1)),
         ((math.cos(-0.04), math.sin(-0.04), 0.0, 0.0), (-0.2, 0.1, 0.0))]


def write_colmap(root, xyz, rgb, binary):
    """A COLMAP sparse model (one PINHOLE camera, POSES, the points) in
    text or binary under root/sparse/0."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    if not binary:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write(f"1 PINHOLE {W} {H} {FOCAL} {FOCAL} {W / 2} {H / 2}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            for i, (q, t) in enumerate(POSES):
                f.write(f"{i + 1} {' '.join(map(repr, q))} {' '.join(map(repr, t))} 1 "
                        f"v{i}.png\n1.0 2.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for i, (p, c) in enumerate(zip(xyz, rgb)):
                f.write(f"{i + 1} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r} {c[0]} {c[1]} {c[2]} 0.5\n")
        return
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, W, H))
        f.write(struct.pack("<dddd", FOCAL, FOCAL, W / 2, H / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(POSES)))
        for i, (q, t) in enumerate(POSES):
            f.write(struct.pack("<i4d3di", i + 1, *q, *t, 1) + f"v{i}.png".encode() + b"\0")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBd", i + 1, *map(float, p), *map(int, c), 0.5))
            f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, i))


@pytest.mark.parametrize("binary", [False, True])
def test_colmap_init_matches_jax(tmp_path, binary):
    """colmap_init (and so create_from_pcd and mean_knn_dist_sq) on 60
    sparse points: parameters within 1e-6, degrees at the maximum, the
    scene extent from the image centres."""
    rng = np.random.default_rng(41)
    xyz = rng.normal(0.0, 1.0, (60, 3)) + np.array([0.0, 0.0, 4.0])
    rgb = rng.integers(0, 256, (60, 3)).astype(np.uint8)
    write_colmap(str(tmp_path), xyz, rgb, binary)
    jm = j_colmap_init(JModel(3), str(tmp_path))
    tm = t_colmap_init(TModel(3, device="cpu"), str(tmp_path))
    assert tm.num_points == jm.num_points == 60
    assert tm.spatial_lr_scale == pytest.approx(jm.spatial_lr_scale, rel=1e-12)
    assert tm.spatial_lr_scale > 0.2
    for name, p in tm.param_dict().items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jm.parameters()[name])[:60],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (tm._degrees == 3).all() and tm._degrees.shape == (60,)
    np.testing.assert_allclose(torch.sigmoid(tm._opacity).detach().numpy(), 0.1, rtol=1e-6)
    np.testing.assert_allclose(tm._xyz.detach().numpy(), xyz.astype(np.float32))


def test_create_from_pcd_scales_from_knn():
    """Scales are log sqrt(max(mean_knn_dist_sq, 1e-7)), isotropic, on the
    model's device; a duplicated point clamps at 1e-7."""
    pts = np.array([[0.0, 0, 0], [1.0, 0, 0], [10.0, 0, 0], [10.0, 0, 0]], np.float32)
    tm = TModel(3, device="cpu").create_from_pcd(pts, np.full((4, 3), 0.5, np.float32), 2.5)
    want = np.log(np.sqrt(np.maximum(tk.mean_knn_dist_sq(torch.from_numpy(pts)).numpy(), 1e-7)))
    np.testing.assert_allclose(tm._scaling.detach().numpy(), np.repeat(want[:, None], 3, 1))
    assert tm._features_dc.detach().abs().max() == 0 and tm.spatial_lr_scale == 2.5
    assert tm._features_rest.shape == (4, 15, 3) and (tm._rotation[:, 0] == 1).all()


# ---------------------------------------------------------- the onions
def onion(trainer):
    """Class names from the outermost trainer wrapper inwards, each
    DensificationTrainer followed by its densifier chain."""
    names, t = [], trainer
    while t is not None:
        names.append(type(t).__name__)
        d = getattr(t, "densifier", None)
        while d is not None:
            names.append(type(d).__name__)
            d = getattr(d, "base_densifier", None)
        t = getattr(t, "base_trainer", None)
    return names


COMPOSITIONS = [
    (tcomb, jcomb, "FullPruningTrainer"),
    (tcomb, jcomb, "BaseFullPruningTrainer"),
    (tcomb, jcomb, "FullReducedDensificationTrainer"),
    (tcomb, jcomb, "BaseFullReducedDensificationTrainer"),
    (tcomb, jcomb, "OpacityResetFullReducedDensificationTrainer"),
    (tcomb, jcomb, "SHCullingOpacityResetDensificationTrainer"),
    (tcomb, jcomb, "SHCullingFullPruningTrainer"),
    (tcomb, jcomb, "SHCullingFullReducedDensificationTrainer"),
    (tcomb, jcomb, "SHCullingOpacityResetFullReducedDensificationTrainer"),
    (tpruning, jpruning, "BasePruningTrainer"),
    (tpruning, jpruning, "PruningTrainer"),
    (tpruning, jpruning, "BaseReducedDensificationTrainer"),
    (tpruning, jpruning, "ReducedDensificationTrainer"),
]


@pytest.mark.parametrize("tmod,jmod,name", COMPOSITIONS, ids=[c[2] for c in COMPOSITIONS])
def test_composition_onion_matches_jax(tmod, jmod, name):
    params, degrees = random_cloud_np(42, 8)
    cams = [dict(height=16, width=16, fovx=1.0, fovy=1.0, R=np.eye(3, dtype=np.float32),
                 T=np.zeros(3, np.float32), bg=np.zeros(3, np.float32))]
    t = getattr(tmod, name)(torch_model(params, degrees), torch_dataset(cams))
    j = getattr(jmod, name)(jax_model(params, degrees), jax_dataset(cams))
    assert onion(t) == onion(j)
    if "Reduced" in name or "FullPruning" in name:
        assert "BasePruner" in onion(t)


def test_flagship_onion_and_pruner_settings():
    """The flagship's layers, and the keys the JAX package's
    PruningDensifierWrapper passes down rather than to its pruner."""
    params, degrees = random_cloud_np(43, 8)
    cams = [dict(height=16, width=16, fovx=1.0, fovy=1.0, R=np.eye(3, dtype=np.float32),
                 T=np.array([float(i), 0, 0], np.float32), bg=np.zeros(3, np.float32))
            for i in range(2)]
    ds = torch_dataset(cams)
    t = tcomb.SHCullingOpacityResetFullReducedDensificationTrainer(
        torch_model(params, degrees), ds, scene_extent=7.0, prune_big_from_iter=5,
        box_size=2.0, mercy_type="opacity")
    assert onion(t) == ["SHCuller", "OpacityResetter", "DepthSupervisor", "DensificationTrainer",
                        "BasePruner", "SplitCloneDensifier", "ImportancePruner",
                        "NoopDensifier", "Trainer"]
    pruner = t.base_trainer.base_trainer.base_trainer.densifier
    assert pruner.scene_extent == pytest.approx(ds.scene_extent())
    assert pruner.prune_big_from_iter == 3000 and pruner.prune_interval == 100
    assert (pruner.box_size, pruner.mercy_type) == (2.0, "opacity")
    assert pruner.base_densifier.scene_extent == 7.0


# ------------------------------------------------------ the flagship run
RUN_STEPS = 12
SPLIT_STEP, PRUNE_STEP, IMPORTANCE_STEP, CULL_STEP, RESET_STEP = 3, 5, 7, 9, 10
PERCENT = 0.1
RUN_CONFIG = dict(
    # As tests/test_torch_densification.py: 100x the default position rate,
    # so a clone leaves its source by more than the last-bit depth
    # differences of the packages.
    sh_degree_up_interval=2, position_lr_init=0.016, position_lr_final=0.00016,
    densify_from_iter=SPLIT_STEP, densify_until_iter=SPLIT_STEP, densify_interval=SPLIT_STEP,
    densify_grad_threshold=0.02, densify_percent_dense=0.7,
    prune_from_iter=PRUNE_STEP, prune_until_iter=PRUNE_STEP, prune_interval=PRUNE_STEP,
    prune_opacity_threshold=0.3, box_size=3.0,
    importance_prune_from_iter=IMPORTANCE_STEP, importance_prune_until_iter=IMPORTANCE_STEP,
    importance_prune_interval=IMPORTANCE_STEP, importance_prune_percent=PERCENT,
    # The 10th percentile of the opacity score decides (as in
    # tests/test_torch_reduction.py).
    importance_prune_thr_important_score=1e9,
    cull_at_steps=[CULL_STEP], cdist_threshold=0.3, std_threshold=0.01,
    opacity_reset_interval=RESET_STEP, opacity_reset_until_iter=RESET_STEP,
    opacity_reset_value=0.01, depth_l1_weight_max_steps=10)


def _layers(trainer):
    """(DensificationTrainer, BasePruner, SplitCloneDensifier) of the flagship
    (under any wrappers over it)."""
    dt = trainer
    while not hasattr(dt, "densifier"):
        dt = dt.base_trainer
    return dt, dt.densifier, dt.densifier.base_densifier


def _flagship(package):
    def build(model, dataset):
        return package.SHCullingOpacityResetFullReducedDensificationTrainer(model, dataset,
                                                                           **RUN_CONFIG)
    return build


def jax_half(jtr, jm, jds, views):
    """Step the JAX trainer over the cameras ``views`` (indices into
    ``jds``), recording the capacity its split draws at, every removal mask,
    the mercy masks, the losses, N and the degrees after each step."""
    j_dt, _, j_split = _layers(jtr)
    capacity, j_masks, j_mercy = {}, {}, {}
    j_split_fn, j_apply = j_split.densify_and_prune, j_dt.apply_instruction

    def j_record_split(loss, out, camera, step):
        capacity[step] = j_split.trainer.engine.model.parameters()["xyz"].shape[0]
        return j_split_fn(loss, out, camera, step)

    def j_record_apply(instruction):
        if instruction.remove_mask is not None:
            j_masks[j_dt.curr_step] = np.asarray(instruction.remove_mask)[:jm.num_points]
        return j_apply(instruction)

    j_mercy_fn = jp.mercy_gaussians

    def j_record_mercy(model, *args, **kwargs):
        mask = j_mercy_fn(model, *args, **kwargs)
        j_mercy[j_dt.curr_step] = np.asarray(mask)
        return mask

    j_split.densify_and_prune = j_record_split
    j_dt.apply_instruction = j_record_apply
    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "mercy_gaussians", j_record_mercy)
    j_losses, j_n, j_deg = [], [], {}
    try:
        for it, view in enumerate(views):
            j_losses.append(float(jtr.step(jds[view])[0]))
            j_n.append(jm.num_points)
            j_deg[it + 1] = np.asarray(jm.aux_state()["degrees"])[:jm.num_points]
    finally:
        mp.undo()
    return dict(jtr=jtr, capacity=capacity, j_masks=j_masks, j_mercy=j_mercy,
                j_losses=j_losses, j_n=j_n, j_deg=j_deg)


def _view_depths(model, camera):
    """(depths, rect_min, rect_max, seen) of the renderer the model uses."""
    with torch.no_grad():
        if isinstance(model, VariableSHGsplat2DGSGaussianModel):
            pre = twodgs.preprocess_2dgs(*model.render_array_args(), model.render_settings(camera))
            return pre["depths"], pre["rect_min"], pre["rect_max"], pre["tiles_touched"] > 0
        pre = common.preprocess(*model.render_array_args(), model.render_settings(camera))
        return pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched > 0


def torch_half(ttr, tm, tds, capacity, drive):
    """The port's half: the split fed the JAX draw at ``capacity``, each
    decision's inputs recorded, and the losses, N and degrees after each
    step. ``drive(step)`` runs the steps, calling ``step(camera)``."""
    t_dt, t_pruner, t_split = _layers(ttr)
    k = t_split.densify_n_split
    t_split.draw_samples = lambda n, step: _jax_draw(capacity[step], step, n, k)
    rec = {"split": {}, "prune": {}, "mercy": {}, "importance": [], "cull": [], "masks": {},
           "events": {}, "depth": []}
    t_split_fn, t_prune_fn, t_apply = t_split.densify_and_prune, t_pruner.prune, \
        t_dt.apply_instruction

    def t_record_split(loss, out, camera, step):
        if t_split.fires(step):
            e = ttr.engine
            rec["split"][step] = (e.xyz_grad_accum.clone(), e.xyz_grad_denom.clone(),
                                  torch.exp(tm._scaling.detach()).max(dim=1).values)
        return t_split_fn(loss, out, camera, step)

    def t_record_prune():
        rec["prune"][ttr.curr_step] = torch.sigmoid(tm._opacity.detach()[:, 0])
        return t_prune_fn()

    def t_record_apply(instruction):
        if instruction.remove_mask is not None:
            added = sum(int(sp.select.sum()) * sp.copies for sp in instruction.appends)
            rec["masks"][ttr.curr_step] = instruction.remove_mask.clone().numpy()
            rec["events"][ttr.curr_step] = (tm.num_points, added)
        return t_apply(instruction)

    t_mercy_fn, t_prune_list, t_colours = tp.mercy_gaussians, timp.prune_list, \
        tsh.calculate_colours_variance

    def t_record_mercy(model, dataset, *args, **kwargs):
        rec["mercy"][ttr.curr_step] = dict(
            params={n: v.detach().clone() for n, v in model.param_dict().items()},
            mask=t_mercy_fn(model, dataset, *args, **kwargs))
        return rec["mercy"][ttr.curr_step]["mask"]

    def t_record_prune_list(model, dataset, resize=None, **kwargs):
        lists = t_prune_list(model, dataset, resize, **kwargs)
        rec["importance"].append((lists, model.get_scaling.detach().clone()))
        return lists

    def t_record_colours(*args, **kwargs):
        stats = t_colours(*args, **kwargs)
        rec["cull"].append(stats)
        return stats

    t_forward = ttr.engine.forward_loss

    def t_record_forward(loss_fn, camera, extras):
        rec["depth"].append(_view_depths(tm, camera))
        return t_forward(loss_fn, camera, extras)

    t_split.densify_and_prune = t_record_split
    t_pruner.prune = t_record_prune
    t_dt.apply_instruction = t_record_apply
    ttr.engine.forward_loss = t_record_forward
    t_losses, t_n, t_deg = [], [], {}
    t_step = ttr.step

    def step(camera):
        result = t_step(camera)
        t_losses.append(float(result[0]))
        t_n.append(tm.num_points)
        t_deg[len(t_losses)] = tm._degrees.clone().numpy()
        return result

    mp = pytest.MonkeyPatch()
    mp.setattr(tp, "mercy_gaussians", t_record_mercy)
    mp.setattr(timp, "prune_list", t_record_prune_list)
    mp.setattr(tsh, "calculate_colours_variance", t_record_colours)
    try:
        drive(step)
    finally:
        mp.undo()
    return dict(ttr=ttr, tds=tds, t_losses=t_losses, t_n=t_n, t_deg=t_deg, rec=rec, k=k,
                split=t_split, pruner=t_pruner)


def flagship_run(jax_build=_flagship(jcomb), torch_build=_flagship(tcomb)):
    """The toy run in both packages: JAX step by step, then the port fed
    the JAX draw, with each decision's inputs recorded. ``jax_build`` and
    ``torch_build`` make each package's trainer from (model, dataset)."""
    params, degrees, cams, images, depths = toy_scene(with_depth=True)
    depths = [depths[0], None, None]
    order = [i % 3 for i in range(RUN_STEPS)]
    jm = jax_model(params, degrees)
    jds = jax_dataset(cams, images, depths)
    j = jax_half(jax_build(jm, jds), jm, jds, order)
    tm = torch_model(params, degrees)
    tds = torch_dataset(cams, images, depths)

    def drive(step):
        for it in range(RUN_STEPS):
            step(tds[order[it]])

    return dict(j, **torch_half(torch_build(tm, tds), tm, tds, j["capacity"], drive))


@pytest.fixture(scope="module")
def run():
    return flagship_run()


def check_decision_margins(run):
    """The split, the opacity prune, the mercy event (quadratic forms, KNN
    k-th against (k+1)-th distance, counts against the threshold,
    opacities against the median), the importance scores, the SH cull's
    statistics, and the depth order of every two Gaussians sharing a tile."""
    rec, split = run["rec"], run["split"]
    for depths, rect_min, rect_max, seen in rec["depth"]:
        d, lo, hi = depths[seen].double(), rect_min[seen], rect_max[seen]
        share = ((torch.maximum(lo[:, None], lo[None]) < torch.minimum(hi[:, None], hi[None]))
                 .all(dim=-1))
        gap = (d[:, None] - d[None]).abs()
        near = share & (gap > 0) & (gap <= 1e-6 * d.abs().max())
        assert not near.any(), gap[near]
    assert list(rec["split"]) == [SPLIT_STEP] and list(rec["prune"]) == [PRUNE_STEP]
    accum, denom, max_scaling = rec["split"][SPLIT_STEP]
    grads = torch.where(denom > 0, accum / torch.clamp(denom, min=1), 0.0)
    assert_decision_margin(grads.numpy(), RUN_CONFIG["densify_grad_threshold"])
    assert_decision_margin(max_scaling.numpy(), split.densify_percent_dense * split.scene_extent)
    assert_decision_margin(rec["prune"][PRUNE_STEP].numpy(), RUN_CONFIG["prune_opacity_threshold"])

    ev = rec["mercy"][PRUNE_STEP]
    p = {n: v.numpy() for n, v in ev["params"].items()}
    xyz = torch.from_numpy(p["xyz"])
    full, inv, hs, ws = tp.camera_matrices(run["tds"])
    cube = tp.find_minimum_projected_pixel_size(full, inv, xyz, hs, ws)
    radius = (cube * RUN_CONFIG["box_size"] * math.sqrt(3.0) / 2.0).numpy()
    _, ids = tk.knn(xyz, 30)
    exact_d, exact_i = tk.knn_exact(xyz, 31)
    assert [set(r) for r in ids.tolist()] == [set(r) for r in exact_i[:, :30].tolist()]
    assert (exact_d[:, 30] - exact_d[:, 29] > 1e-5 * exact_d[:, 29]).all()
    q = quadratic_forms(p["xyz"], np.exp(p["scaling"]), p["rotation"], ids.numpy(), radius)
    assert_decision_margin(q, 1.0, rel=Q_MARGIN)
    counts = tp.redundancy_minimum(ids, torch.from_numpy(q < 1)).numpy().astype(np.float64)
    thr = max(counts.mean() + counts.std(ddof=1), 3)
    assert_decision_margin(counts, thr)
    opacity = torch.sigmoid(torch.from_numpy(p["opacity"][:, 0]))
    med = tp.masked_median(opacity, torch.from_numpy(counts > thr))
    assert_decision_margin(opacity.numpy(), float(med))

    (count, op_score, t_alpha), scaling = rec["importance"][0]
    pct = np.sort(op_score.numpy())[int(PERCENT * (op_score.numel() - 1))]
    assert_decision_margin(op_score.numpy(), pct)
    glist = count.numpy().astype(np.float32)
    assert_decision_margin(glist, min(1.0, np.sort(glist)[int(PERCENT * (glist.size - 1))]))
    vol = torch.prod(scaling, 1)
    v = (op_score * torch.pow(vol / torch.sort(vol, descending=True).values[
        int(0.9 * op_score.numel())], 0.1)).numpy()
    assert_decision_margin(v, min(3.0, np.sort(v)[int(PERCENT * (v.size - 1))]))
    assert_decision_margin(t_alpha.numpy(), min(1.0, np.sort(t_alpha.numpy())[
        int(PERCENT * (t_alpha.numel() - 1))]))
    avg = np.where(glist > 0, t_alpha.numpy() / np.maximum(glist, 1), 0)
    assert_decision_margin(avg, min(0.001, np.sort(avg)[int(PERCENT * (avg.size - 1))]))
    (_, variance, _), (distances, _, _) = rec["cull"]
    std = np.nan_to_num(np.sqrt(variance.numpy())).mean(axis=2)[:, 0]
    assert_decision_margin(std, RUN_CONFIG["std_threshold"])
    for band in (1, 2):
        assert_decision_margin(distances.numpy()[:, band], RUN_CONFIG["cdist_threshold"])


def test_flagship_decisions_have_margins(run):
    check_decision_margins(run)


def test_flagship_events(run):
    """Every event happens, and N moves at each by the appended rows minus
    the OR of the removal masks; the mercy mask is not empty."""
    rec, t_n, k = run["rec"], run["t_n"], run["k"]
    n0 = len(run["j_deg"][1])
    assert sorted(rec["masks"]) == [SPLIT_STEP, PRUNE_STEP, IMPORTANCE_STEP]
    mercy = rec["mercy"][PRUNE_STEP]["mask"]
    assert 0 < int(mercy.sum()) and mercy.shape == (t_n[PRUNE_STEP - 2],)
    assert (rec["masks"][PRUNE_STEP] >= mercy.numpy()).all()
    assert int(rec["masks"][IMPORTANCE_STEP].sum()) > 0
    for step, mask in rec["masks"].items():
        n_before, added = rec["events"][step]
        assert mask.shape == (n_before,)
        assert t_n[step - 1] == n_before + added - int(mask.sum())
        assert (added > 0) == (step == SPLIT_STEP)
    deg = run["t_deg"]
    assert (deg[CULL_STEP] < deg[CULL_STEP - 1][:len(deg[CULL_STEP])]).any()
    state = run["ttr"].engine.state_trees()
    assert float(torch.sigmoid(run["ttr"].model._opacity.detach()).max()) < 1.0
    assert all(v.shape[0] == t_n[-1] for t in state.values() for v in t.values())


def check_masks_and_row_counts(run):
    assert run["t_n"] == run["j_n"]
    assert sorted(run["rec"]["masks"]) == sorted(run["j_masks"])
    for step, mask in run["rec"]["masks"].items():
        np.testing.assert_array_equal(mask, run["j_masks"][step], err_msg=f"step {step}")
    assert list(run["j_mercy"]) == [PRUNE_STEP]
    np.testing.assert_array_equal(run["rec"]["mercy"][PRUNE_STEP]["mask"].numpy(),
                                  run["j_mercy"][PRUNE_STEP])
    for step, deg in run["j_deg"].items():
        np.testing.assert_array_equal(run["t_deg"][step], deg, err_msg=f"step {step}")


def test_flagship_masks_and_row_counts_match_jax(run):
    check_masks_and_row_counts(run)


def check_losses_and_state(run):
    np.testing.assert_allclose(run["t_losses"], run["j_losses"], rtol=1e-4)
    n, j = _jax_live(run["jtr"])
    t = run["ttr"].engine.state_trees()
    for group in ("params", "adam_m", "adam_v", "accum"):
        for name, v in t[group].items():
            jv = j[group][name]
            assert v.shape == jv.shape, (group, name)
            np.testing.assert_allclose(v.numpy(), jv, rtol=1e-3, atol=1e-6 * np.abs(jv).max(),
                                       err_msg=f"{group}/{name}")


def test_flagship_losses_and_state_match_jax(run):
    check_losses_and_state(run)
