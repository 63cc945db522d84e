"""PyTorch port vs JAX package: the colour statistics of SH culling and the
cull itself.

Both packages render the same three cameras with statistics (the port's
plain statistics compositor, the JAX package's XLA path) from Gaussians of
mixed SH degrees. ``calculate_colours_variance`` must agree at rtol 1e-4 and
atol 1e-5; ``cull_sh_bands`` must set the same degrees and features within
1e-5, at active SH degree 0 and 3. The thresholds are set between two JAX
values, and the test asserts that no JAX statistic lies within 1e-5
(relative) of the threshold it meets before it compares degrees exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops import shculling_stats as tstats  # noqa: E402
from reduced_3dgs_torch.shculling import cull_sh_bands as tcull  # noqa: E402
from reduced_3dgs_tpu.ops import shculling_stats as jstats  # noqa: E402
from reduced_3dgs_tpu.shculling import cull_sh_bands as jcull  # noqa: E402
from reduced_3dgs_tpu.shculling import trainer as jtrainer  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  random_cloud_np, torch_dataset, torch_model, views_np)


def _scene(active):
    params, degrees = random_cloud_np(61, 80, spread=0.9)
    cams = views_np(3, 40, 56)
    jm, tm = jax_model(params, degrees), torch_model(params, degrees)
    jm.active_sh_degree = tm.active_sh_degree = active
    return params, degrees, jm, jax_dataset(cams), tm, torch_dataset(cams)


def _between(values, q=0.4):
    """A threshold halfway between the q-quantile of ``values`` and the next
    larger value."""
    v = np.unique(np.asarray(values, np.float64))
    i = int(q * (v.size - 1))
    return float((v[i] + v[i + 1]) / 2)


@pytest.mark.parametrize("active", [0, 3])
def test_colours_variance_matches_jax(active):
    params, degrees, jm, jds, tm, tds = _scene(active)
    j = jstats.calculate_colours_variance(jds, jm, jm.parameters(), jnp.asarray(degrees),
                                          active)
    tparams = {k: p.detach() for k, p in tm.param_dict().items()}
    t = tstats.calculate_colours_variance(tds, tm, tparams, torch.from_numpy(degrees), active)
    assert t[0].shape == (80, max(active, 1)) and t[1].shape == t[2].shape == (80, 1, 3)
    for name, a, b in zip(("avg_dist", "variance", "mean"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)
    # At degree 0 the colour does not depend on the view: no variance.
    assert active == 0 or (np.asarray(j[1]).max() > 0 and np.asarray(j[0]).max() > 0)


def test_colours_by_degree_matches_jax():
    rng = np.random.default_rng(62)
    feats = rng.normal(0, 0.4, (30, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(30, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    degrees = rng.integers(0, 4, 30).astype(np.int32)
    t = tstats.colours_by_degree(torch.from_numpy(feats), torch.from_numpy(dirs),
                                 torch.from_numpy(degrees))
    j = jstats.colours_by_degree(jnp.asarray(feats), jnp.asarray(dirs), jnp.asarray(degrees))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    assert (t.numpy()[np.arange(4)[None, :] > degrees[:, None]] == 0).all()


@pytest.mark.parametrize("active", [0, 3])
def test_cull_sh_bands_matches_jax(active):
    params, degrees, jm, jds, tm, tds = _scene(active)
    # The thresholds, and their margins, from the JAX package's two passes.
    jd = jnp.asarray(degrees)
    _, var, mean = jstats.calculate_colours_variance(jds, jm, jm.parameters(), jd, active)
    std = np.nan_to_num(np.sqrt(np.asarray(var))).mean(axis=2)[:, 0]
    std_threshold = _between(std) if active > 0 else 0.04      # all std 0 at degree 0
    assert_decision_margin(std, std_threshold)
    d2, f_dc, f_rest = jtrainer._low_variance_colour_culling(
        jd, jm.parameters()["features_dc"], jm.parameters()["features_rest"], std_threshold,
        var, mean)
    p2 = dict(jm.parameters(), features_dc=f_dc, features_rest=f_rest)
    dist, _, _ = jstats.calculate_colours_variance(jds, jm, p2, d2, active)
    dist = np.asarray(dist)
    cdist_threshold = _between(dist[:, 1]) if active > 1 else 0.1
    for band in range(1, active):
        assert_decision_margin(dist[:, band], cdist_threshold)

    jcull(jm, jds, cdist_threshold, std_threshold)
    tcull(tm, tds, cdist_threshold, std_threshold)
    t_deg, j_deg = tm._degrees.numpy(), np.asarray(jm.aux_state()["degrees"])
    np.testing.assert_array_equal(t_deg, j_deg)
    assert (j_deg == 0).sum() > (degrees == 0).sum()             # low variance culled
    if active == 3:
        assert ((j_deg > 0) & (j_deg < degrees)).any()           # low distance capped
    for name in ("features_dc", "features_rest"):
        np.testing.assert_allclose(tm.param_dict()[name].detach().numpy(),
                                   np.asarray(jm.parameters()[name]), atol=1e-5, err_msg=name)


def test_cull_writes_in_place_and_leaves_adam_alone():
    """The cull rewrites the features of the same ``nn.Parameter``s and
    leaves the trainer's Adam moments as they were; SHCuller refuses a model
    without per-Gaussian degrees."""
    from reduced_3dgs_torch.models import GaussianModel
    from reduced_3dgs_torch.shculling import BaseSHCullingTrainer, SHCuller
    from reduced_3dgs_torch.trainer import BaseTrainer
    params, degrees, _, _, tm, tds = _scene(3)
    cams = list(tds)
    for cam in cams:
        cam.ground_truth_image = torch.full((3, cam.image_height, cam.image_width), 0.5)
    trainer = BaseSHCullingTrainer(tm, tds, cull_at_steps=[], std_threshold=0.04)
    trainer.step(cams[0])
    moments = {k: (m.clone(), trainer.engine.adam.v[k].clone())
               for k, m in trainer.engine.adam.m.items()}
    dc = tm._features_dc
    before = dc.detach().clone()
    tcull(tm, tds, 0.1, 0.04)
    assert tm._features_dc is dc and not torch.equal(dc.detach(), before)
    for k, (m, v) in moments.items():
        assert torch.equal(trainer.engine.adam.m[k], m) and torch.equal(trainer.engine.adam.v[k], v)
    with pytest.raises(TypeError, match="VariableSHGaussianModel"):
        plain = GaussianModel(3, device="cpu").load_numpy(params)
        SHCuller(BaseTrainer(plain, tds), tds)
