"""PyTorch port vs JAX package: K-Means (ops/kmeans.py).

Both packages get the same numpy inputs and, where the JAX side seeds with
k-means++, the JAX package's seed centres, which the port cannot draw. Ids
are compared exactly after ``assert_argmin_margin`` holds every row's best
distance 1e-5 from its second best, relative to the larger of the second
distance and |x|^2 + |c|^2 (the scale of the expansion's rounding);
centres within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reduced_3dgs_torch.ops import kmeans as tk  # noqa: E402
from reduced_3dgs_tpu.ops import kmeans as jk  # noqa: E402

from .test_torch_fixtures import assert_decision_margin  # noqa: E402

MARGIN = 1e-5
PAIRWISE = tk.pairwise_sq_dists   # tests below wrap the module's to record calls


def argmin_margins(x, c):
    """[N] gap between each row's two nearest centres relative to the larger
    of the second distance and |x|^2 + |c|^2 of the nearest: the expansion
    |x|^2 - 2 x.c + |c|^2 rounds at about float32's epsilon times the
    latter, so a smaller gap is the last bits'."""
    x, c = torch.as_tensor(x), torch.as_tensor(c)
    top2 = torch.topk(PAIRWISE(x, c).double(), 2, dim=1, largest=False)
    d = top2.values
    scale = torch.maximum(d[:, 1], (torch.sum(x * x, dim=1)
                                    + torch.sum(c * c, dim=1)[top2.indices[:, 0]]).double())
    return ((d[:, 1] - d[:, 0]) / torch.clamp(scale, min=1e-30)).numpy()


def assert_argmin_margin(x, c, rel=MARGIN):
    """Every row's argmin over the centres c has a margin of ``rel``
    (``argmin_margins``), so the last bits cannot flip it."""
    m = argmin_margins(x, c)
    assert (m > rel).all(), m.min()


def data(seed, n=600, d=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def jax_seed(x, k, weights=None, seed=0):
    w = jnp.ones(x.shape[0]) if weights is None else jnp.asarray(weights)
    return np.array(jk._kmeanspp_init(jax.random.PRNGKey(seed), jnp.asarray(x), w, k))


def jax_lloyd(x, weights, c0, max_iter, tol):
    centers, ids = jk._lloyd(jnp.asarray(x), jnp.asarray(weights), jnp.asarray(c0),
                             c0.shape[0], max_iter, jnp.asarray(tol, jnp.float32))
    return np.asarray(centers), np.asarray(ids)


def effective_iterations(centers_after, cap=40):
    """The Lloyd iterations that change the result: the first max_iter whose
    centres equal those of a run capped at ``cap``. (An iteration whose
    shift is exactly 0 changes nothing, so a run that stops there is the
    same run.)"""
    final = centers_after(cap)
    for m in range(1, cap + 1):
        if np.array_equal(centers_after(m), final):
            return m
    raise AssertionError("no iteration count reproduces the capped run")


def test_pairwise_sq_dists_matches_jax():
    x, c = data(0, 500, 7), data(1, 40, 7)
    t = tk.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    j = np.asarray(jk._pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-5)
    exact = ((x.astype(np.float64)[:, None] - c[None]) ** 2).sum(-1)
    np.testing.assert_allclose(t, exact, rtol=1e-5, atol=1e-5)
    assert (t >= 0).all()


@pytest.mark.parametrize("chunk", [65536, 37])
def test_assign_matches_jax(chunk):
    """Whole and in chunks (JAX's ``lax.map`` branch with padding)."""
    x, c = data(2, 300), data(3, 24)
    assert_argmin_margin(torch.from_numpy(x), torch.from_numpy(c))
    t = tk.assign(torch.from_numpy(x), torch.from_numpy(c), chunk=chunk)
    j = np.asarray(jk.assign(jnp.asarray(x), jnp.asarray(c), chunk=chunk))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), j)


def test_argmin_takes_the_first_index_on_ties():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    c = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0]])
    np.testing.assert_array_equal(tk.assign(x, c).numpy(), [0, 0])
    np.testing.assert_array_equal(np.asarray(jk.assign(jnp.asarray(x.numpy()),
                                                       jnp.asarray(c.numpy()))), [0, 0])


def test_lloyd_fixed_iterations_matches_jax(monkeypatch):
    """tol = 0 and 8 iterations from JAX's seeding: the argmin of every
    iteration has a margin, ids are equal and centres within 1e-5."""
    x = data(4, 800)
    c0 = jax_seed(x, 16)
    calls = []
    pairwise = tk.pairwise_sq_dists

    def record(a, b):
        calls.append((a, b))
        return pairwise(a, b)

    monkeypatch.setattr(tk, "pairwise_sq_dists", record)
    tc, ti, iters = tk.lloyd(torch.from_numpy(x), torch.ones(800), torch.from_numpy(c0), 8, 0.0)
    monkeypatch.undo()
    assert iters == 8 and len(calls) == 9
    for a, b in calls:
        assert_argmin_margin(a, b)
    jc, ji = jax_lloyd(x, np.ones(800, np.float32), c0, 8, 0.0)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    # kmeans with the K seed centres as its warm start is the same run.
    kc, ki = tk.kmeans(torch.from_numpy(x), 16, init_centers=torch.from_numpy(c0), max_iter=8,
                       tol=0.0)
    assert torch.equal(kc, tc) and torch.equal(ki, ti)


def port_shifts(x, weights, c0, n):
    """Squared centre shift of each of the port's first n iterations."""
    prev, shifts = c0, []
    for m in range(1, n + 1):
        c = tk.lloyd(x, weights, c0, m, 0.0)[0]
        shifts.append(float(torch.sum((c - prev) ** 2)))
        prev = c
    return np.array(shifts)


def tol_eff(x, tol, correction=0):
    return tol * max(float(torch.mean(torch.var(x, dim=0, correction=correction))), 1e-30)


@pytest.mark.parametrize("case", ["default_tol", "population_variance"])
def test_stopping_rule_matches_jax(case):
    """The port stops after the first iteration whose shift is at most
    tol_eff, every shift held 1e-5 from it, and runs as many iterations that
    change the result as JAX, with an equal result. In
    ``population_variance`` (10 rows) the threshold lies between the first
    shift over the population variance and over the sample variance
    (``torch.var``'s default ``correction=1``), and the second shift is not
    0: the port goes on past the first iteration, as JAX does, where the
    sample variance would stop it there with another result."""
    xn, k = (data(5, 900), 12) if case == "default_tol" else (data(1, 10, 2), 3)
    x, w, wn = torch.from_numpy(xn), torch.ones(xn.shape[0]), np.ones(xn.shape[0], np.float32)
    c0 = jax_seed(xn, k)
    shifts = port_shifts(x, w, torch.from_numpy(c0), 40)
    if case == "default_tol":
        tol = 1e-4
    else:
        var0, var1 = tol_eff(x, 1.0, 0), tol_eff(x, 1.0, 1)
        tol = shifts[0] / np.sqrt(var0 * var1)
        assert tol * var0 < shifts[0] <= tol * var1 and shifts[1] > 0
    assert_decision_margin(shifts, tol_eff(x, tol))
    tc, ti, iters = tk.lloyd(x, w, torch.from_numpy(c0), 300, tol)
    assert iters == int(np.argmax(shifts <= tol_eff(x, tol))) + 1 < 40
    jc, ji = jax_lloyd(xn, wn, c0, 300, tol)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), ji)
    j_iters = effective_iterations(lambda m: jax_lloyd(xn, wn, c0, m, tol)[0])
    t_iters = effective_iterations(lambda m: tk.lloyd(x, w, torch.from_numpy(c0), m, tol)[0]
                                   .numpy())
    assert t_iters == j_iters
    if case == "population_variance":
        assert iters == 2 and t_iters >= 2
        assert not np.array_equal(tk.lloyd(x, w, torch.from_numpy(c0), 1, tol)[0].numpy(), jc)


def test_zero_weight_rows_are_excluded():
    x = np.concatenate([np.random.default_rng(7).normal(0, 1, (50, 2)),
                        np.full((50, 2), 100.0)]).astype(np.float32)
    w = np.concatenate([np.ones(50), np.zeros(50)]).astype(np.float32)
    c0 = jax_seed(x, 4, w)
    assert np.abs(c0).max() < 50
    tc, ti = tk.kmeans(torch.from_numpy(x), 4, weights=torch.from_numpy(w),
                       init_centers=torch.from_numpy(c0), max_iter=20)
    jc, ji = jk.kmeans(jnp.asarray(x), 4, weights=jnp.asarray(w), init_centers=jnp.asarray(c0),
                       max_iter=20)
    assert np.abs(tc.numpy()).max() < 50
    assert_argmin_margin(torch.from_numpy(x), tc)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_single_cluster_is_the_weighted_mean():
    x = data(8, 50, 2)
    w = np.random.default_rng(9).uniform(0, 2, 50).astype(np.float32)
    tc, ti = tk.kmeans(torch.from_numpy(x), 1, weights=torch.from_numpy(w))
    jc, _ = jk.kmeans(jnp.asarray(x), 1, weights=jnp.asarray(w))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy()[0], (x * w[:, None]).sum(0) / w.sum(), rtol=1e-5)
    assert ti.shape == (50,) and not ti.any()


def test_warm_start_with_k_rows_draws_nothing(monkeypatch):
    """K or more given rows: the first K start Lloyd, nothing is drawn."""
    x = data(10, 400)
    init = data(11, 10)

    def no_draw(*args, **kwargs):
        raise AssertionError("k-means++ drew")

    monkeypatch.setattr(tk, "kmeanspp_init", no_draw)
    monkeypatch.setattr(jk, "_kmeanspp_init", no_draw)
    tc, ti = tk.kmeans(torch.from_numpy(x), 8, init_centers=torch.from_numpy(init), max_iter=5)
    jc, ji = jk.kmeans(jnp.asarray(x), 8, init_centers=jnp.asarray(init), max_iter=5)
    assert_argmin_margin(torch.from_numpy(x), tc)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_warm_start_with_fewer_rows_keeps_them_first(monkeypatch):
    """Fewer than K given rows: k-means++ seeds, then the given rows
    overwrite the first ones."""
    x = torch.from_numpy(data(12, 400))
    init = torch.from_numpy(data(13, 3))
    starts = []
    lloyd = tk.lloyd

    def record(x, weights, init_centers, max_iter, tol):
        starts.append(init_centers.clone())
        return lloyd(x, weights, init_centers, max_iter, tol)

    monkeypatch.setattr(tk, "lloyd", record)
    tk.kmeans(x, 8, init_centers=init, max_iter=5, seed=3)
    seeded = tk.kmeanspp_init(x, torch.ones(400), 8, seed=3)
    assert torch.equal(starts[0][:3], init)
    assert torch.equal(starts[0][3:], seeded[3:])


def _blobs(seed, k=4, per=100, d=3, sep=10.0):
    rng = np.random.default_rng(seed)
    centers = sep * np.random.default_rng(42).normal(size=(k, d))
    pts = np.concatenate([c + 0.1 * rng.normal(size=(per, d)) for c in centers])
    return pts.astype(np.float32), centers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_own_seeding_recovers_blobs(seed):
    """tests/test_kmeans.py's blobs test with the port's own draw."""
    pts, true_centers = _blobs(seed)
    centers, ids = tk.kmeans(torch.from_numpy(pts), 4, max_iter=50, seed=seed)
    d = np.linalg.norm(centers.numpy()[:, None] - true_centers[None], axis=-1)
    assert (d.min(axis=1) < 0.5).all()
    ids = ids.numpy()
    for blob in range(4):
        assert len(set(ids[blob * 100:(blob + 1) * 100])) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_own_seeding_inertia_is_close_to_jax(seed):
    """On the same data and settings, the port's own k-means++ reaches an
    inertia within 1.1x the JAX package's."""
    x = data(20 + seed, 3000)

    def inertia(c, i):
        return float(((x - np.asarray(c)[np.asarray(i)]) ** 2).sum())

    tc, ti = tk.kmeans(torch.from_numpy(x), 16, max_iter=300, seed=seed)
    jc, ji = jk.kmeans(jnp.asarray(x), 16, max_iter=300, seed=seed)
    assert inertia(tc.numpy(), ti.numpy()) <= 1.1 * inertia(jc, ji)


def test_seeding_draws_rows_by_weight():
    """k-means++ never seeds at a row of weight 0, and an all-zero weight
    vector draws without error."""
    x = torch.from_numpy(np.concatenate([data(30, 100, 2), np.full((100, 2), 50.0, np.float32)]))
    w = torch.cat([torch.ones(100), torch.zeros(100)])
    c = tk.kmeanspp_init(x, w, 8, seed=5)
    assert c.abs().max() < 40
    assert torch.isfinite(tk.kmeanspp_init(x, torch.zeros(200), 4)).all()
