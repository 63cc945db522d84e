"""PyTorch port vs JAX package: rendered-importance pruning.

Both packages sweep the same three cameras with statistics (the port's
plain statistics compositor, the JAX package's XLA path), and
``prune_gaussians`` must give the same removal mask for each of the seven
types, with and without ``resize``. A mask decides ``score <= threshold``,
which flips on the last bit, so the test first asserts that no JAX score
lies within 1e-5 (relative) of the threshold it meets, and then compares
the masks exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import importance as timp  # noqa: E402
from reduced_3dgs_tpu import importance as jimp  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, jax_dataset, jax_model,  # noqa: E402
                                  random_cloud_np, torch_dataset, torch_model, views_np)

PERCENT = 0.3
# Per type, its threshold keyword and value: set between the scene's
# smallest score and its 30th percentile, so that both bind somewhere;
# "comprehensive" ORs the types with a threshold.
THRESHOLDS = {
    "important_score": ("prune_thr_important_score", None),
    "v_important_score": ("prune_thr_v_important_score", 20.0),
    "max_v_important_score": ("prune_thr_max_v_important_score", None),
    "count": ("prune_thr_count", 45),
    "T_alpha": ("prune_thr_T_alpha", 3.0),
    "T_alpha_avg": ("prune_thr_T_alpha_avg", 0.06),
}
TYPES = sorted(THRESHOLDS) + ["comprehensive"]
RESIZE = 40


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(51, 90, spread=0.9)
    cams = views_np(3, 48, 64)
    return (jax_model(params, degrees), jax_dataset(cams), torch_model(params, degrees),
            torch_dataset(cams))


def _jax_scores(jm, jds, resize):
    """The JAX package's score vector of each type, from its own sweep."""
    count, opacity, t_alpha = jimp.prune_list(jm, jds, resize)
    glist = count.astype(jnp.float32)
    n = opacity.shape[0]
    return {
        "important_score": opacity,
        "v_important_score": jimp.calculate_v_imp_score(jm, opacity, 0.1),
        "max_v_important_score": opacity * jnp.max(jm.get_scaling[:n], axis=1),
        "count": glist,
        "T_alpha": t_alpha,
        "T_alpha_avg": jnp.where(glist > 0, t_alpha / jnp.maximum(glist, 1), 0.0),
    }


@pytest.mark.parametrize("resize", [None, RESIZE])
@pytest.mark.parametrize("prune_type", TYPES)
def test_prune_gaussians_matches_jax(scene, prune_type, resize):
    jm, jds, tm, tds = scene
    thresholds = {kw: thr for kw, thr in THRESHOLDS.values()}
    if prune_type != "comprehensive":
        thresholds = {THRESHOLDS[prune_type][0]: THRESHOLDS[prune_type][1]}
    scores = _jax_scores(jm, jds, resize)
    for name, (kw, _) in THRESHOLDS.items():
        if kw in thresholds and (thresholds[kw] is not None or prune_type == name):
            s = np.asarray(scores[name])
            pct = np.sort(s)[int(PERCENT * (s.shape[0] - 1))]
            thr = pct if thresholds[kw] is None else min(np.float32(thresholds[kw]), pct)
            assert_decision_margin(s, thr)
    j_mask = np.asarray(jimp.prune_gaussians(jm, jds, resize, prune_type, PERCENT,
                                             v_pow=0.1, **thresholds))
    t_mask = timp.prune_gaussians(tm, tds, resize, prune_type, PERCENT, v_pow=0.1,
                                  **thresholds)
    assert t_mask.dtype == torch.bool and t_mask.shape == (tm.num_points,)
    np.testing.assert_array_equal(t_mask.numpy(), j_mask)
    assert 0 < j_mask.sum() < j_mask.size


def test_prune_list_resize_and_unknown_type(scene):
    """The sweep sums one statistics render per camera; ``resize`` renders
    each camera with its longer side at that many pixels; an unknown type
    raises ValueError."""
    jm, jds, tm, tds = scene
    full = timp.prune_list(tm, tds)
    small = timp.prune_list(tm, tds, resize=RESIZE)
    assert full[0].dtype == torch.int32 and full[0].sum() > small[0].sum() > 0
    per_camera = sum(timp.count_render(tm, cam)["gaussians_count"] for cam in tds)
    assert torch.equal(full[0], per_camera)
    j_full = jimp.prune_list(jm, jds, RESIZE)
    np.testing.assert_array_equal(small[0].numpy(), np.asarray(j_full[0]))
    with pytest.raises(ValueError, match="Unsupported pruning method"):
        timp.prune_gaussians(tm, tds, prune_type="volume")


def test_score2mask_and_v_imp_score_match_jax():
    rng = np.random.default_rng(52)
    score = rng.uniform(0, 5, 50).astype(np.float32)
    for percent, thr in ((0.1, None), (0.5, 1.0), (0.9, 10.0)):
        np.testing.assert_array_equal(
            timp.score2mask(percent, torch.from_numpy(score), thr).numpy(),
            np.asarray(jimp.score2mask(percent, jnp.asarray(score), thr)))
    params, degrees = random_cloud_np(53, 40)
    jm, tm = jax_model(params, degrees), torch_model(params, degrees)
    np.testing.assert_allclose(
        timp.calculate_v_imp_score(tm, torch.from_numpy(score[:40]), 0.1).numpy(),
        np.asarray(jimp.calculate_v_imp_score(jm, jnp.asarray(score[:40]), 0.1)), rtol=1e-6)
