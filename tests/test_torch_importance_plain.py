"""PyTorch port vs the benchmark's plain reference: rendered-importance
statistics and pruning rules (``gpubench/reference/importance.py``, plain
PyTorch that imports nothing of the port).

On 2,000 seeded random Gaussians of mixed SH degrees and six 64 x 48 views
of one FoV:

  * ``prune_list``'s static sweep and ``exact_counts`` against the
    reference's sums: the counts within the gate's last bit, the two float
    sums within ``TOL_SCORE``;
  * ``prune_gaussians`` of every type against the reference's rules on the
    port's own sums: the masks equal outside the rows the reference finds
    within 1e-5 (relative) of a threshold;
  * a sweep that leaves out its first view fails the comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpubench.reference import importance as ref  # noqa: E402
from gpubench.reference import render as ref_render  # noqa: E402
from reduced_3dgs_torch.dataset import camera as camera_mod  # noqa: E402
from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402

from .test_torch_fixtures import (random_cloud_np, torch_dataset, torch_model,  # noqa: E402
                                  views_np)

N = 2000
H, W = 48, 64
VIEWS = 6
# A pixel's gate (power <= 0, alpha >= 1/255) and latch (T < 1e-4) may flip
# where the port's and the reference's preprocess round a field's last bit
# apart: a share of the counted pixels, summed over the Gaussians (0 here;
# 1.5e-7 to 1.8e-7 at the benchmark's truck scale on the card).
TOL_COUNT = 1e-4
# The float sums differ by the last bits of each field and by the order of
# float32 additions (per entry, per view): 5e-8 relative here, ~1e-5 at
# truck scale, where a Gaussian's sum holds thousands of terms.
TOL_SCORE = 1e-5
PERCENT = 0.3
# Per type, its threshold keyword and value, set between the scene's
# smallest score and its 30th percentile so that both bind somewhere.
THRESHOLDS = {
    "important_score": ("prune_thr_important_score", None),
    "v_important_score": ("prune_thr_v_important_score", 20.0),
    "max_v_important_score": ("prune_thr_max_v_important_score", None),
    "count": ("prune_thr_count", 45),
    "T_alpha": ("prune_thr_T_alpha", 3.0),
    "T_alpha_avg": ("prune_thr_T_alpha_avg", 0.06),
}
TYPES = sorted(THRESHOLDS) + ["comprehensive"]


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(61, N, spread=0.9, scale_lo=-4.0, scale_hi=-2.5)
    cams = views_np(VIEWS, H, W)
    model = torch_model(params, degrees)
    dataset = torch_dataset(cams)
    torch_params = {k: torch.tensor(v) for k, v in params.items()}
    views = [ref_render.make_view(c["R"].T, c["T"], H, W, c["fovx"], c["fovy"]) for c in cams]
    sums = ref.sweep(torch_params, torch.tensor(degrees), views)
    return dict(model=model, dataset=dataset, params=torch_params, views=views, sums=sums)


def gaps(program, reference) -> dict:
    """count: sum |count_p - count_r| over sum count_r; opacity, t_alpha:
    relative norm gaps."""
    count_p, count_r = program[0].double(), reference["count"].double()
    out = {"count": float((count_p - count_r).abs().sum() / count_r.sum())}
    for name, p in zip(("opacity", "t_alpha"), program[1:]):
        r = reference[name]
        out[name] = float((p.double() - r).norm() / r.norm())
    return out


def test_the_scene_is_seen(scene):
    """Most Gaussians contribute somewhere, so that the comparisons below
    compare something."""
    count = scene["sums"]["count"]
    assert (count > 0).float().mean() > 0.5 and int(count.sum()) > 10 * N


def test_static_sweep_matches_the_reference(scene):
    cams = camera_mod.sweep_cameras(scene["dataset"])
    assert timp.sweeps_statically(scene["model"], cams)
    out = gaps(timp.prune_list(scene["model"], scene["dataset"]), scene["sums"])
    assert out["count"] <= TOL_COUNT, out
    assert max(out["opacity"], out["t_alpha"]) <= TOL_SCORE, out


def test_exact_counts_match_the_reference(scene):
    cams = camera_mod.sweep_cameras(scene["dataset"])
    out = gaps(timp.exact_counts(scene["model"], cams), scene["sums"])
    assert out["count"] <= TOL_COUNT, out
    assert max(out["opacity"], out["t_alpha"]) <= TOL_SCORE, out


def test_a_sweep_without_its_first_view_fails(scene):
    cams = camera_mod.sweep_cameras(scene["dataset"])
    out = gaps(timp.sweep_counts(scene["model"], cams[1:]), scene["sums"])
    assert out["count"] > 10 * TOL_COUNT, out
    assert min(out["opacity"], out["t_alpha"]) > 10 * TOL_SCORE, out


@pytest.mark.parametrize("prune_type", TYPES)
def test_prune_gaussians_matches_the_reference_rules(scene, prune_type):
    model = scene["model"]
    kwargs = {key: value for key, value in THRESHOLDS.values()}
    mask = timp.prune_gaussians(model, scene["dataset"], None, prune_type, PERCENT, **kwargs)
    count, opacity, t_alpha = timp.prune_list(model, scene["dataset"])
    thresholds = {kind: value for kind, (_, value) in THRESHOLDS.items()}
    expected, near = ref.prune_mask(count, opacity, t_alpha, model._scaling.detach(),
                                    prune_type, PERCENT, thresholds)
    assert 0 < int(expected.sum()) < N
    assert int(near.sum()) <= N // 100
    assert torch.equal(mask & ~near, expected & ~near)


def test_the_reference_rules_follow_the_options():
    options = {"importance_prune_type": "count", "importance_prune_percent": 0.2,
               "importance_prune_thr_count": 5, "importance_v_pow": 0.5}
    rules = ref.rules(options)
    assert rules["prune_type"] == "count" and rules["percent"] == 0.2
    assert rules["thresholds"]["count"] == 5 and rules["v_pow"] == 0.5
    assert rules["thresholds"]["T_alpha_avg"] == ref.THRESHOLDS["T_alpha_avg"]
    assert ref.faulty_rules("percent", rules)["percent"] == 0.4
    assert ref.faulty_rules("no_t_alpha_avg", rules)["thresholds"]["T_alpha_avg"] is None
    score = torch.tensor(np.arange(10, dtype=np.float32))
    mask, near = ref.score_mask(score, 0.5, 3.0)
    assert mask.tolist() == [True] * 4 + [False] * 6
    assert near.tolist() == [False] * 3 + [True] + [False] * 6
