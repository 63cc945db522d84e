"""PyTorch port vs JAX package: the densification trainer's remove path.

A densifier that removes a fixed set of rows after step 2 drives both
packages' ``DensificationTrainer`` over a ``BaseTrainer`` for three steps on
a toy scene (80 Gaussians of mixed SH degrees, three 40x56 views, the JAX
model on its XLA tiled path). Afterwards the port's parameters, Adam
moments, densification statistics and degrees must equal the JAX engine's
live rows at PR 2's bars (rtol 1e-3), the row count and degrees exactly,
and the port's state after the removal must be exactly its state before it,
cut to the kept rows in order."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import trainer as ttrainer  # noqa: E402
from reduced_3dgs_tpu import trainer as jtrainer  # noqa: E402

from .test_torch_fixtures import (jax_dataset, jax_model, random_cloud_np,  # noqa: E402
                                  torch_dataset, torch_model, views_np)

N = 80
REMOVE_AT = 2
STEPS = 3


def toy_scene(seed=71, n=N, views=3, hw=(40, 56)):
    """(perturbed params, degrees, camera dicts, ground-truth images): the
    images are the JAX package's renders of the unperturbed scene."""
    params, degrees = random_cloud_np(seed, n, spread=0.9)
    cams = views_np(views, *hw)
    gt_model = jax_model(params, degrees)
    images = [np.clip(np.asarray(gt_model(cam)["render"]), 0, 1)
              for cam in jax_dataset(cams)]
    rng = np.random.default_rng(seed + 1)
    sigma = dict(xyz=0.01, features_dc=0.05, features_rest=0.02, scaling=0.1,
                 rotation=0.02, opacity=0.2)
    perturbed = {k: (v + sigma[k] * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
    return perturbed, degrees, cams, images


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
    with pytest.raises(NotImplementedError, match="densification slice"):
        ttr.apply_instruction(ttrainer.DensificationInstruction(new_points={"xyz": None}))
    ttr.apply_instruction(ttrainer.DensificationInstruction())
    assert tm.num_points == 5
