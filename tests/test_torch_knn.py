"""PyTorch port vs JAX package: spatial KNN (ops/knn.py).

The same numpy points go through both packages on the CPU, where the JAX
package's approximate top-k is exact, so both compute the same algorithm
with the same top-k. Morton codes must be equal integer for integer; the
rotated coordinates of the two packages may differ in their last bit, so a
test of an ordering first asserts that the codes of both rotated clouds are
equal. Neighbour sets are compared as sets: the order of equal distances
is not part of the contract."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops import knn as tk  # noqa: E402
from reduced_3dgs_tpu.ops import knn as jk  # noqa: E402

from tools.knn_recall import clustered_cloud  # noqa: E402


def _points(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _sets(ids):
    return [set(row.tolist()) for row in np.asarray(ids)]


@pytest.mark.parametrize("order", [0, 1, 2])
def test_morton_codes_equal_jax(order):
    """Codes equal on 5,000 points, unrotated and in the rotated frames of
    the second and third orderings (each package rotating its own copy)."""
    p = _points(0, 5000)
    rot = tk._order_rotation(order)
    if rot is None:
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
    else:
        np.testing.assert_array_equal(rot, np.asarray(jk._order_rotation(order)))
        jp = jnp.asarray(p) @ jnp.asarray(rot).T
        tp = torch.from_numpy(p) @ torch.from_numpy(rot).T
    jc = np.asarray(jk.morton_codes(jp)).astype(np.int64)
    tc = tk.morton_codes(tp).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert tc.max() < 2 ** 30 and len(np.unique(tc)) > 4000


def test_blocked_search_identity_ordering_equals_jax():
    """One ordering's blocked search (300 points, blocks of 16, one block on
    each side): equal neighbour sets, after a margin on the k-th distance so
    that no (k+1)-th candidate ties it in the last bits."""
    p = _points(1, 300)
    k = 8
    assert np.array_equal(np.asarray(jk.morton_codes(jnp.asarray(p))).astype(np.int64),
                          tk.morton_codes(torch.from_numpy(p)).numpy())
    jd, ji = jk._order_blocked_topk(jnp.asarray(p), None, None, k, block=16, neighbors=1,
                                    approx=True)
    td, ti = tk._order_blocked_topk(torch.from_numpy(p), None, None, k, block=16, neighbors=1)
    wide, _ = tk._order_blocked_topk(torch.from_numpy(p), None, None, k + 1, block=16,
                                     neighbors=1)
    gap = (wide[:, k] - wide[:, k - 1]).numpy()
    assert (gap > 1e-5 * wide[:, k - 1].numpy()).all()
    assert _sets(ti.numpy()) == _sets(ji)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (td.numpy() > 0).all() and not (ti.numpy() == np.arange(300)[:, None]).any()


def test_merge_keeps_the_first_copy_of_each_id():
    """The merge of lists that share ids returns no id twice and keeps the
    distance of an id's first list; knn's rows hold no repeated id."""
    d = torch.tensor([[[1.0, 2.0, 3.0], [1.5, 2.0, 9.0]]])
    i = torch.tensor([[[4, 5, 6], [7, 4, 8]]])
    md, mi = tk._merge_klists(d, i, 4)
    assert mi[0].tolist() == [4, 7, 5, 6] and md[0].tolist() == [1.0, 1.5, 2.0, 3.0]
    p = _points(3, 50)
    _, ids = tk.knn(torch.from_numpy(p), 8, window=50, n_orders=3)
    assert all(len(set(row.tolist())) == 8 for row in ids)


@pytest.fixture(scope="module")
def default_knn():
    """The default knn (k 30) on a 5,000-point copy of the clustered cloud
    of tools/knn_recall.py, both packages, and the exact neighbours."""
    p = clustered_cloud(5000, seed=0)
    jd, ji = jk.knn(jnp.asarray(p), 30)
    td, ti = tk.knn(torch.from_numpy(p), 30)
    _, ei = tk.knn_exact(torch.from_numpy(p), 30)
    return dict(p=p, jd=np.asarray(jd), ji=np.asarray(ji), td=td.numpy(), ti=ti.numpy(),
                ei=ei.numpy())


def test_default_knn_sets_equal_jax(default_knn):
    same = np.mean([a == b for a, b in zip(_sets(default_knn["ti"]), _sets(default_knn["ji"]))])
    assert same >= 0.999, same
    assert (default_knn["ti"] >= 0).all() and np.isfinite(default_knn["td"]).all()
    assert (np.diff(default_knn["td"], axis=1) >= 0).all()


def test_default_knn_recall_matches_jax(default_knn):
    exact = _sets(default_knn["ei"])

    def recall(ids):
        return np.mean([len(a & b) / 30 for a, b in zip(_sets(ids), exact)])

    rt, rj = recall(default_knn["ti"]), recall(default_knn["ji"])
    assert abs(rt - rj) <= 0.005, (rt, rj)
    assert rt > 0.9


def test_knn_index_subset_equals_jax():
    """Only flagged points come back as neighbours; the flagged rows'
    neighbour sets equal the JAX package's knn with the same mask."""
    p = _points(4, 2000)
    mask = np.random.default_rng(5).uniform(size=2000) < 0.6
    jd, ji = jk.knn(jnp.asarray(p), 12, mask=jnp.asarray(mask))
    td, ti = tk.knn_index_subset(torch.from_numpy(p), 12, torch.from_numpy(mask))
    ti = ti.numpy()
    assert mask[ti[mask]].all()
    same = np.mean([a == b for a, b in zip(_sets(ti[mask]), _sets(np.asarray(ji)[mask]))])
    assert same >= 0.999, same
    _, ei = tk.knn_exact(torch.from_numpy(p), 12, mask=torch.from_numpy(mask))
    recall = np.mean([len(a & b) / 12 for a, b in zip(_sets(ti[mask]), _sets(ei.numpy()[mask]))])
    assert recall > 0.99


def test_knn_exact_equals_jax():
    p = _points(6, 300)
    jd, ji = jk.knn_exact(jnp.asarray(p), 10)
    td, ti = tk.knn_exact(torch.from_numpy(p), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_mean_knn_dist_sq_matches_jax():
    p = clustered_cloud(5000, seed=1)
    j = np.asarray(jk.mean_knn_dist_sq(jnp.asarray(p)))
    t = tk.mean_knn_dist_sq(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_mean_knn_dist_sq_counts_the_point_itself():
    """distCUDA2's semantics: points at 0, 1 and 10 on a line give
    (1 + 100) / 3, (1 + 81) / 3 and (81 + 100) / 3."""
    p = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [10.0, 0, 0]])
    np.testing.assert_allclose(tk.mean_knn_dist_sq(p, window=8).numpy(),
                               [101 / 3, 82 / 3, 181 / 3], rtol=1e-6)


def test_short_rows_get_inf_and_id_minus_one():
    """With N <= k a row has N - 1 neighbours: the other slots hold an
    infinite distance and id -1 in the port, where the JAX package's ids are
    -1 with bit 30 cleared; the real neighbours agree."""
    p = _points(7, 10)
    jd, ji = jk.knn(jnp.asarray(p), 30)
    td, ti = tk.knn(torch.from_numpy(p), 30)
    ji, ti, td = np.asarray(ji), ti.numpy(), td.numpy()
    assert (ti[:, 9:] == -1).all() and np.isinf(td[:, 9:]).all()
    assert (ji[:, 9:] == -1 - 2 ** 30).all() and np.isinf(np.asarray(jd)[:, 9:]).all()
    assert _sets(ti[:, :9]) == _sets(ji[:, :9])
    assert all(s == set(range(10)) - {r} for r, s in enumerate(_sets(ti[:, :9])))


def clustered_recall_against_jax(n=262_144, k=30, queries=2048):
    """Recall@k of both packages' default knn on tools/knn_recall.py's
    clustered cloud (seed 0) against an exact oracle on its query sample
    (seed 1), and the share of rows whose id sets agree."""
    import jax
    p = clustered_cloud(n, seed=0)
    rows = np.sort(np.random.default_rng(1).choice(n, queries, replace=False))
    pt = torch.from_numpy(p)
    d = tk._sq_dist(pt[rows][:, None, :], pt[None, :, :])
    d[torch.arange(queries), torch.from_numpy(rows)] = float("inf")
    oracle = _sets(torch.topk(d, k, largest=False).indices.numpy())
    ti = tk.knn(pt, k)[1].numpy()
    ji = np.asarray(jax.jit(lambda x: jk.knn(x, k))(jnp.asarray(p))[1])
    recall = {name: np.mean([len(a & b) / k for a, b in zip(_sets(ids[rows]), oracle)])
              for name, ids in (("port", ti), ("jax", ji))}
    same = np.mean([a == b for a, b in zip(_sets(ti), _sets(ji))])
    return recall, same


if __name__ == "__main__":
    # python -m tests.test_torch_knn: both packages on the CPU at the size
    # chip_smoke.py measures the port on the card.
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(clustered_recall_against_jax())
