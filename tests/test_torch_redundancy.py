"""PyTorch port vs JAX package: the redundancy metric and the mercy policy
(ops/redundancy.py, pruning/trainer.py).

The same numpy scene goes through both packages on the CPU. Decisions at a
threshold are held to a margin first (``assert_decision_margin``): the
quadratic form of the sphere-ellipsoid test against 1 (computed here in
float64; the packages' matrix inverses and products differ in their last
bits), the redundancy counts against the mercy threshold, the opacities
against the median or quantile they meet. Then the masks and counts are
compared exactly."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops import knn as tk  # noqa: E402
from reduced_3dgs_torch.ops import redundancy as tr  # noqa: E402
from reduced_3dgs_torch.pruning import trainer as tp  # noqa: E402
from reduced_3dgs_tpu.ops import knn as jk  # noqa: E402
from reduced_3dgs_tpu.ops import redundancy as jr  # noqa: E402
from reduced_3dgs_tpu.pruning import trainer as jp  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, camera_np, jax_dataset,  # noqa: E402
                                  jax_model, random_cloud_np, rotation_y, torch_dataset,
                                  torch_model)

N = 200
BOX = 4.0   # pixels per sphere: intersections are common at 40x56
# The packages' sphere radii differ as their pixel sizes do (up to
# TOL_PIXEL_ROTATED), so a quadratic form must clear 1 by more than that.
Q_MARGIN = 1e-3


def _cams():
    """Three views: landscape, portrait, and landscape turned about y."""
    return [camera_np(40, 56), camera_np(56, 40, T=np.array([0.05, 0.0, 0.1], np.float32)),
            camera_np(48, 64, R=rotation_y(0.1), T=np.array([-0.1, 0.02, 0.0], np.float32))]


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(34, N, spread=0.6)
    cams = _cams()
    return dict(params=params, degrees=degrees, cams=cams, jm=jax_model(params, degrees),
                tm=torch_model(params, degrees), jds=jax_dataset(cams), tds=torch_dataset(cams))


def _rotmat(q):
    q = q / np.sqrt(np.sum(q * q, axis=-1, keepdims=True))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
        axis=-1).reshape(q.shape[:-1] + (3, 3))


def quadratic_forms(xyz, scales, rotations, ids, radius):
    """float64 sum_a ((x_i - x_j) R_i)_a^2 / (s_j,a + r_i)^2 per (i, slot)."""
    xyz, scales, radius = (np.asarray(a, np.float64) for a in (xyz, scales, radius))
    safe = np.maximum(ids, 0)
    local = np.einsum("nki,nij->nkj", xyz[:, None, :] - xyz[safe],
                      _rotmat(np.asarray(rotations, np.float64)))
    return np.sum(local ** 2 / (scales[safe] + radius[:, None, None]) ** 2, axis=-1)


def _port_metric_inputs(scene):
    """The port's pixel sizes, KNN ids and quadratic forms of the scene at BOX."""
    tm, params = scene["tm"], scene["params"]
    full, inv, hs, ws = tp.camera_matrices(scene["tds"])
    cube = tr.find_minimum_projected_pixel_size(full, inv, tm._xyz.detach(), hs, ws)
    radius = (cube * BOX * math.sqrt(3.0) / 2.0).numpy()
    _, ids = tk.knn(tm._xyz.detach(), 30)
    q = quadratic_forms(params["xyz"], np.exp(params["scaling"]), params["rotation"],
                        ids.numpy(), radius)
    return cube, ids, q


# Pixel sizes of a rotated camera: the unprojection of the NDC depth z,
# near 1 (znear 0.01), loses precision, one float32 step of z moving the
# result by some 2e-5 of itself. The JAX package's jitted projection
# contracts products and sums into fused multiply-adds where the camera's
# matrix has off-diagonal terms, so its last bits differ from plain float32
# arithmetic, and so do its pixel sizes, by up to 1e-4; both sit that far
# from a float64 evaluation. Unrotated cameras give equal bits.
TOL_PIXEL_ROTATED = 2e-4


def test_pixel_size_matches_jax():
    """Three cameras, landscape, portrait (both unrotated: within 1e-5 of
    the JAX package) and a landscape one turned about y (within
    TOL_PIXEL_ROTATED, as is a float64 evaluation); a point outside every
    frustum and one behind the cameras keep the initial 10000."""
    params, _ = random_cloud_np(32, 64, spread=0.6)
    xyz = np.concatenate([params["xyz"], [[100.0, 0.0, 3.0], [0.0, 0.0, -5.0]]]).astype(np.float32)
    cams = _cams()
    jfull = jnp.stack([c.full_proj_transform for c in jax_dataset(cams)])
    jinv = jnp.linalg.inv(jfull)
    full, inv, hs, ws = tp.camera_matrices(torch_dataset(cams))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6, atol=1e-6)

    def both(sel):
        j = np.asarray(jr.find_minimum_projected_pixel_size(
            jfull[sel], jinv[sel], jnp.asarray(xyz), jnp.array(hs[sel]), jnp.array(ws[sel])))
        t = tr.find_minimum_projected_pixel_size(full[sel], inv[sel], torch.from_numpy(xyz),
                                                 hs[sel], ws[sel]).numpy()
        return t, j

    for i, rtol in ((0, 1e-5), (1, 1e-5), (2, TOL_PIXEL_ROTATED)):
        t, j = both(slice(i, i + 1))
        np.testing.assert_allclose(t, j, rtol=rtol, err_msg=f"camera {i}")
        t64 = tr.find_minimum_projected_pixel_size(
            full[i:i + 1].double(), torch.linalg.inv(full[i:i + 1].double()),
            torch.from_numpy(xyz).double(), hs[i:i + 1], ws[i:i + 1]).numpy()
        np.testing.assert_allclose(t, t64, rtol=TOL_PIXEL_ROTATED, err_msg=f"camera {i}")
        assert (t[-2:] == 10000.0).all() and (t[:-2] < 1.0).all()
    t, j = both(slice(0, 3))
    np.testing.assert_allclose(t, j, rtol=TOL_PIXEL_ROTATED)
    one = [both(slice(i, i + 1))[0][:-2] for i in range(3)]
    assert (t[:-2] == np.minimum(np.minimum(one[0], one[1]), one[2])).all()


def test_sphere_ellipsoid_intersection_matches_jax(scene):
    """Given JAX's neighbour lists, masks and counts equal after the margin
    on the quadratic form; with the neighbour's rotation too."""
    params = scene["params"]
    _, ji = jk.knn(jnp.asarray(params["xyz"]), 30)
    ji = np.asarray(ji)
    scales = np.exp(params["scaling"]).astype(np.float32)
    rot = params["rotation"] / np.sqrt(np.sum(params["rotation"] ** 2, -1, keepdims=True))
    rot = rot.astype(np.float32)
    radius = np.random.default_rng(33).uniform(0.02, 0.3, N).astype(np.float32)
    assert_decision_margin(quadratic_forms(params["xyz"], scales, rot, ji, radius), 1.0)
    for neighbour in (False, True):
        jc, jmask = jr.sphere_ellipsoid_intersection(
            jnp.asarray(params["xyz"]), jnp.asarray(scales), jnp.asarray(rot), jnp.asarray(ji),
            jnp.asarray(radius), use_neighbour_rotation=neighbour)
        tc, tmask = tr.sphere_ellipsoid_intersection(
            torch.from_numpy(params["xyz"]), torch.from_numpy(scales), torch.from_numpy(rot),
            torch.from_numpy(ji.astype(np.int64)), torch.from_numpy(radius),
            use_neighbour_rotation=neighbour)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert 0 < int(tc.sum()) < N * 30


def test_allocate_minimum_redundancy_value_matches_jax():
    """The reference's example, then a random metric layout (self first)
    with pad slots, which both packages skip."""
    vals = np.array([5, 2, 9], np.int32)
    nbrs = np.array([[0, 1], [1, 2], [2, 0]])
    mask = np.array([[True, True], [True, True], [True, False]])
    t = tr.allocate_minimum_redundancy_value(torch.from_numpy(vals), torch.from_numpy(nbrs),
                                             torch.from_numpy(mask))
    assert t.tolist() == [3, 2, 2] == np.asarray(jr.allocate_minimum_redundancy_value(
        jnp.asarray(vals), jnp.asarray(nbrs), jnp.asarray(mask))).tolist()
    rng = np.random.default_rng(34)
    n, k = 60, 6
    vals = rng.integers(1, 9, n).astype(np.int32)
    nbrs = np.concatenate([np.arange(n)[:, None], rng.integers(0, n, (n, k))], axis=1)
    nbrs[rng.uniform(size=nbrs.shape) < 0.1] = -1
    nbrs[:, 0] = np.arange(n)
    mask = rng.uniform(size=nbrs.shape) < 0.5
    mask[:, 0] = True
    j = np.asarray(jr.allocate_minimum_redundancy_value(jnp.asarray(vals), jnp.asarray(nbrs),
                                                        jnp.asarray(mask)))
    t = tr.allocate_minimum_redundancy_value(torch.from_numpy(vals), torch.from_numpy(nbrs),
                                             torch.from_numpy(mask))
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.dtype == torch.int32


def test_calculate_redundancy_metric_matches_jax(scene):
    """Exact counts (both packages' KNN is exact at N = 200, window 512)."""
    cube, ids, q = _port_metric_inputs(scene)
    assert_decision_margin(q, 1.0, rel=Q_MARGIN)
    assert (q < 1).any(axis=1).mean() > 0.2
    jmin, jcube = jp.calculate_redundancy_metric(scene["jm"], scene["jds"], pixel_scale=BOX)
    tmin, tcube = tp.calculate_redundancy_metric(scene["tm"], scene["tds"], pixel_scale=BOX)
    np.testing.assert_allclose(tcube.numpy(), np.asarray(jcube), rtol=TOL_PIXEL_ROTATED)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    assert tmin.dtype == torch.int32 and int(tmin.min()) >= 1 and int(tmin.max()) > 3


def test_short_rows_in_the_redundancy_count():
    """With N <= k (10 points, k = 30), 21 slots of every row are empty. The
    port counts none of them. The JAX package's empty slots carry an id its
    gathers clamp to row 0, so it counts each as point 0: every row whose
    sphere reaches point 0's ellipsoid gains 21, point 0 itself always."""
    rng = np.random.default_rng(35)
    xyz = rng.normal(0.0, 0.3, (10, 3)).astype(np.float32)
    scales = np.full((10, 3), 0.05, np.float32)
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (10, 1))
    radius = np.full(10, 0.2, np.float32)
    _, ji = jk.knn(jnp.asarray(xyz), 30)
    jc, _ = jr.sphere_ellipsoid_intersection(jnp.asarray(xyz), jnp.asarray(scales),
                                             jnp.asarray(rot), ji, jnp.asarray(radius))
    _, ti = tk.knn(torch.from_numpy(xyz), 30)
    tc, tmask = tr.sphere_ellipsoid_intersection(
        torch.from_numpy(xyz), torch.from_numpy(scales), torch.from_numpy(rot), ti,
        torch.from_numpy(radius))
    assert not tmask[:, 9:].any()
    q = quadratic_forms(xyz, scales, rot, ti.numpy(), radius)
    assert_decision_margin(q, 1.0)
    np.testing.assert_array_equal(tc.numpy(), (q[:, :9] < 1).sum(axis=1))
    reaches_0 = quadratic_forms(xyz, scales, rot, np.zeros((10, 1), np.int64), radius)[:, 0] < 1
    assert reaches_0[0] and not reaches_0.all()
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy() + 21 * reaches_0)
    # The minimum never lands on an empty slot.
    tmin = tp.redundancy_minimum(ti, tmask)
    assert tmin.shape == (10,) and int(tmin.max()) <= 10


def _counts_and_opacity(scene):
    assert_decision_margin(_port_metric_inputs(scene)[2], 1.0, rel=Q_MARGIN)
    tmin, _ = tp.calculate_redundancy_metric(scene["tm"], scene["tds"], pixel_scale=BOX)
    return tmin, torch.sigmoid(scene["tm"]._opacity.detach()[:, 0])


def _policy_margins(counts, opacity, lam, minimum, mercy_type):
    """Assert the margins of every decision of the policy; returns the
    redundant mask."""
    c = counts.numpy().astype(np.float64)
    thr = max(c.mean() + lam * c.std(ddof=1), minimum)
    assert_decision_margin(c, thr)
    redundant = c > thr
    op = opacity.numpy()
    if mercy_type in ("redundancy_opacity", "redundancy_opacity_opacity") and redundant.any():
        assert_decision_margin(op, float(tp.masked_median(opacity, torch.from_numpy(redundant))))
    if mercy_type == "opacity":
        assert_decision_margin(op, float(tp.quantile_linear(opacity, 0.045)))
    if mercy_type == "redundancy_opacity_opacity":
        assert_decision_margin(op, min(float(tp.quantile_linear(opacity, 0.03)), 0.05))
    return redundant


@pytest.mark.parametrize("mercy_type", tp.MERCY_TYPES)
def test_mercy_gaussians_matches_jax(scene, mercy_type):
    """One mercy event at BOX pixels, lambda 1, minimum 3, each type; the
    random type is fed the JAX package's draw."""
    counts, opacity = _counts_and_opacity(scene)
    redundant = _policy_margins(counts, opacity, 1.0, 3, mercy_type)
    assert redundant.sum() >= 4
    jm = scene["jm"]
    j = np.asarray(jp.mercy_gaussians(jm, scene["jds"], box_size=BOX, lambda_mercy=1.0,
                                      mercy_minimum=3, mercy_type=mercy_type))
    rand = torch.from_numpy(np.random.default_rng(0).random(jm.capacity).astype(np.float32)[:N])
    t = tp.mercy_gaussians(scene["tm"], scene["tds"], box_size=BOX, lambda_mercy=1.0,
                           mercy_minimum=3, mercy_type=mercy_type, rand=rand).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < N


@pytest.mark.parametrize("mercy_type", tp.MERCY_TYPES)
def test_mercy_points_matches_jax(scene, mercy_type):
    """The policy on given counts with mercy_points' own defaults
    (lambda 2, minimum 2)."""
    counts = np.random.default_rng(36).poisson(3.0, N).astype(np.int32)
    counts[:12] = 15
    opacity = torch.sigmoid(scene["tm"]._opacity.detach()[:, 0])
    _policy_margins(torch.from_numpy(counts), opacity, 2.0, 2, mercy_type)
    j = np.asarray(jp.mercy_points(scene["jm"], jnp.asarray(counts), mercy_type=mercy_type))
    rand = torch.from_numpy(np.random.default_rng(0).random(N).astype(np.float32))
    t = tp.mercy_points(scene["tm"], torch.from_numpy(counts), mercy_type=mercy_type,
                        rand=rand).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.any()


def test_mercy_threshold_takes_the_sample_std(scene):
    """std with ddof 1: the count 6 lies between mean + std (6.07) and the
    threshold a population std would give (5.94), so it is not redundant."""
    counts = np.array([1, 4, 7, 7, 2, 0, 3, 6, 4, 0], np.int32)

    class NoDraw:
        def random(self, n):
            return np.zeros(n)

    j = np.asarray(jp.mercy_points(scene["jm"], jnp.asarray(counts), lambda_mercy=1.0,
                                   mercy_minimum=0, mercy_type="redundancy_random",
                                   rng=NoDraw()))
    t = tp.mercy_points(scene["tm"], torch.from_numpy(counts), lambda_mercy=1.0,
                        mercy_minimum=0, mercy_type="redundancy_random",
                        rand=torch.zeros(10)).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.tolist() == (counts == 7).tolist()


def test_mercy_random_own_draw_takes_half():
    """Without a draw the random type prunes about half of the redundant
    Gaussians, the same ones on every call."""
    n = 20000
    counts = torch.ones(n, dtype=torch.int32)
    counts[:4000] = 10
    opacity = torch.full((n,), 0.5)
    mask = tp.mercy_policy(counts, opacity, 1.0, 3, "redundancy_random")
    assert not mask[4000:].any()
    share = float(mask[:4000].float().mean())
    assert 0.46 < share < 0.54, share
    assert torch.equal(mask, tp.mercy_policy(counts, opacity, 1.0, 3, "redundancy_random"))
    with pytest.raises(ValueError, match="mercy_type"):
        tp.mercy_policy(counts, opacity, 1.0, 3, "nope")


@pytest.mark.parametrize("count", [7, 8, 0])
def test_masked_median_matches_jnp_nanmedian(count):
    """Odd, even and empty sets: the middle value, the mean of the two
    middle ones, NaN."""
    v = np.random.default_rng(37).uniform(size=20).astype(np.float32)
    mask = np.zeros(20, bool)
    mask[np.random.default_rng(38).choice(20, count, replace=False)] = True
    j = float(jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(v), jnp.nan)))
    t = float(tp.masked_median(torch.from_numpy(v), torch.from_numpy(mask)))
    if count == 0:
        assert math.isnan(j) and math.isnan(t)
    else:
        assert t == j
        assert t == (float(np.median(v[mask])) if count % 2 else t)
    for q in (0.03, 0.045, 0.5):
        assert float(tp.quantile_linear(torch.from_numpy(v), q)) == float(
            jnp.quantile(jnp.asarray(v), q))
