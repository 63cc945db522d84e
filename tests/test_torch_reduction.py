"""PyTorch port vs JAX package: the reduction path as a whole.

``SHCullingTrainerWrapper(BaseImportancePruningTrainer, ...)``, that is
SHCuller(DensificationTrainer(Trainer, ImportancePruner(NoopDensifier))),
trains the toy scene of tests/test_torch_densification.py for 12 steps in
both packages: the port through ``train.training()``, the JAX trainer step
by step over the same camera order. Importance pruning fires after steps 4
and 8, the SH cull after step 8, where it must see the pruned model. The
row count and the degrees must agree exactly after each event, the losses
at rtol 1e-4 and the parameters at rtol 1e-3 (PR 2's bars). Each decision
is held to a margin first: no score or statistic lies within 1e-5
(relative) of the threshold it meets."""
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.importance import BaseImportancePruningTrainer as TBaseImp  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.shculling import SHCullingTrainerWrapper as TSHWrap  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_torch.shculling import trainer as tsh  # noqa: E402
from reduced_3dgs_tpu.importance import BaseImportancePruningTrainer as JBaseImp  # noqa: E402
from reduced_3dgs_tpu.shculling import SHCullingTrainerWrapper as JSHWrap  # noqa: E402

from .test_torch_densification import toy_scene  # noqa: E402
from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  torch_dataset, torch_model)

STEPS = 12
PERCENT = 0.1
CONFIG = dict(
    importance_prune_from_iter=4, importance_prune_until_iter=8,
    importance_prune_interval=4, importance_prune_percent=PERCENT,
    # The 10th percentile of the opacity score decides (the defaults of the
    # other criteria stay, and prune nothing on this scene).
    importance_prune_thr_important_score=1e9,
    cull_at_steps=[8], sh_degree_up_interval=2,
    cdist_threshold=0.3, std_threshold=0.01)


def _camera_order(n_views):
    """The camera indices ``training()`` visits with random.Random(0)."""
    rng, order, out = random.Random(0), list(range(n_views)), []
    for step in range(STEPS):
        if step % n_views == 0:
            rng.shuffle(order)
        out.append(order[step % n_views])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, degrees, cams, images = toy_scene()
    degrees = np.full_like(degrees, 3)

    # JAX, step by step, with N and the degrees read after each step.
    jm = jax_model(params, degrees)
    jds = jax_dataset(cams, images)
    jtr = JSHWrap(JBaseImp, jm, jds, **CONFIG)
    j_losses, j_n, j_deg = [], [], {}
    for step, i in enumerate(_camera_order(len(cams)), start=1):
        j_losses.append(float(jtr.step(jds[i])[0]))
        j_n.append(jm.num_points)
        j_deg[step] = np.asarray(jm.aux_state()["degrees"])[:jm.num_points]

    # The port through training(), with the decisions' inputs recorded.
    tm = torch_model(params, degrees)
    tds = torch_dataset(cams, images)
    ttr = TSHWrap(TBaseImp, tm, tds, **CONFIG)
    recorded = {"prune": [], "cull": [], "n": [], "degrees": {}}
    prune_list, colours_variance = timp.prune_list, tsh.calculate_colours_variance

    def record_prune_list(model, dataset, resize=None, **kwargs):
        lists = prune_list(model, dataset, resize, **kwargs)
        recorded["prune"].append((ttr.curr_step, lists, model.get_scaling.detach().clone()))
        return lists

    def record_colours(*args, **kwargs):
        stats = colours_variance(*args, **kwargs)
        recorded["cull"].append(stats)
        return stats

    step_fn = ttr.step

    def step(camera):
        out = step_fn(camera)
        recorded["n"].append(tm.num_points)
        recorded["degrees"][ttr.curr_step] = tm._degrees.clone().numpy()
        return out

    ttr.step = step
    mp = pytest.MonkeyPatch()
    # One step a call: the recorder above wraps trainer.step.
    mp.setenv("R3DGS_WINDOW", "1")
    mp.setattr(timp, "prune_list", record_prune_list)
    mp.setattr(tsh, "calculate_colours_variance", record_colours)
    try:
        out_dir = tmp_path_factory.mktemp("reduction")
        t_losses = ttrain.training(tds, tm, ttr, None, str(out_dir), iteration=STEPS,
                                   save_iterations=[], device="cpu", log_interval=STEPS)
    finally:
        mp.undo()
    return dict(jm=jm, tm=tm, ttr=ttr, j_losses=j_losses, j_n=j_n, j_deg=j_deg,
                t_losses=[float(v) for v in t_losses], recorded=recorded, out_dir=out_dir,
                degrees=degrees)


def test_decisions_have_margins(runs):
    rec = runs["recorded"]
    assert [s for s, _, _ in rec["prune"]] == [4, 8]
    for _, (count, opacity, t_alpha), scaling in rec["prune"]:
        pct = np.sort(opacity.numpy())[int(PERCENT * (opacity.numel() - 1))]
        assert_decision_margin(opacity.numpy(), pct)
        glist = count.numpy().astype(np.float32)
        assert_decision_margin(glist, min(1.0, np.sort(glist)[int(PERCENT * (glist.size - 1))]))
        v = (opacity * torch.pow(torch.prod(scaling, 1) / torch.sort(
            torch.prod(scaling, 1), descending=True).values[int(0.9 * opacity.numel())],
            0.1)).numpy()
        assert_decision_margin(v, min(3.0, np.sort(v)[int(PERCENT * (v.size - 1))]))
        assert_decision_margin(t_alpha.numpy(), min(1.0, np.sort(t_alpha.numpy())[
            int(PERCENT * (t_alpha.numel() - 1))]))
        avg = np.where(glist > 0, t_alpha.numpy() / np.maximum(glist, 1), 0)
        assert_decision_margin(avg, min(0.001, np.sort(avg)[int(PERCENT * (avg.size - 1))]))
    (_, variance, _), (distances, _, _) = rec["cull"]
    std = np.nan_to_num(np.sqrt(variance.numpy())).mean(axis=2)[:, 0]
    assert_decision_margin(std, CONFIG["std_threshold"])
    for band in (1, 2):
        assert_decision_margin(distances.numpy()[:, band], CONFIG["cdist_threshold"])


def test_row_counts_and_degrees_match_jax(runs):
    t_n, j_n = runs["recorded"]["n"], runs["j_n"]
    assert t_n == j_n
    n0 = len(runs["degrees"])
    assert t_n[2] == n0 and t_n[3] < n0 and t_n[7] < t_n[3] and t_n[-1] == t_n[7]
    for step in (4, 8, STEPS):
        np.testing.assert_array_equal(runs["recorded"]["degrees"][step], runs["j_deg"][step],
                                      err_msg=f"step {step}")
    deg = runs["recorded"]["degrees"]
    assert (deg[8] < 3).sum() > 0 and (deg[8] == 3).sum() > 0 and (deg[7] == 3).all()
    engine = runs["ttr"].engine
    for t in engine.state_trees().values():
        for v in t.values():
            assert v.shape[0] == t_n[-1]


def test_losses_and_parameters_match_jax(runs):
    np.testing.assert_allclose(runs["t_losses"], runs["j_losses"], rtol=1e-4)
    n = runs["jm"].num_points
    for name, p in runs["tm"].param_dict().items():
        j = np.asarray(runs["jm"].parameters()[name])[:n]
        np.testing.assert_allclose(p.detach().numpy(), j, rtol=1e-3, atol=1e-6, err_msg=name)


def test_saved_ply_holds_the_reduced_model(runs):
    path = runs["out_dir"] / "point_cloud" / f"iteration_{STEPS}" / "point_cloud.ply"
    back = TModel(3, device="cpu").load_ply(str(path))
    assert back.num_points == runs["tm"].num_points < len(runs["degrees"])
