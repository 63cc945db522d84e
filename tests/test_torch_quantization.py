"""PyTorch port vs JAX package: vector quantization (quantization/).

  * Code widths: equal to the JAX package's wherever its codes fit, one
    type wider where they wrap, and ``u4`` from 131,072 clusters.
  * With the JAX package's codebooks and ids, ``dequantize`` is bit-equal;
    with its codebooks, ``find_nearest_cluster_id`` gives equal ids (after
    ``assert_nearest_decided_alike``: a margin, or distances bit-equal to
    the JAX package's).
  * With equal codebooks preset on both quantizers, the quantized PLY files
    are byte-identical, and each package loads the other's.
  * ``load_quantized`` into a fresh model: the JAX package's cannot render
    (its degrees stay empty), the port's has every degree at the maximum.
  * ``QuantizeTrainerWrapper`` fires at the JAX package's steps, before the
    update.
  * The flagship toy run of tests/test_torch_pruning.py with ``--quantize``
    (``prepare_trainer``), both quantizers' codebooks preset equal, so every
    event starts warm and nothing is drawn: N, removal masks, losses and
    state as in that test, with a margin on every decision, the K-Means
    argmins and stopping rules included.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from reduced_3dgs_torch import prepare as tprepare  # noqa: E402
from reduced_3dgs_torch import quantization as tq  # noqa: E402
from reduced_3dgs_torch.ops import kmeans as tk  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGaussianModel as TModel  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer as TBaseTrainer  # noqa: E402
from reduced_3dgs_tpu import prepare as jprepare  # noqa: E402
from reduced_3dgs_tpu import quantization as jq  # noqa: E402
from reduced_3dgs_tpu.ops import kmeans as jk  # noqa: E402
from reduced_3dgs_tpu.quantization import quantizer as jquantizer  # noqa: E402
from reduced_3dgs_tpu.shculling import VariableSHGaussianModel as JModel  # noqa: E402
from reduced_3dgs_tpu.trainer import BaseTrainer as JBaseTrainer  # noqa: E402

from .test_torch_fixtures import (assert_decision_margin, camera_np, jax_dataset,  # noqa: E402
                                  jax_model, random_cloud_np, torch_dataset, torch_model)
from .test_torch_kmeans import PAIRWISE, argmin_margins, assert_argmin_margin  # noqa: E402
from .test_torch_pruning import (RUN_CONFIG, check_decision_margins,  # noqa: E402
                                 check_losses_and_state, check_masks_and_row_counts,
                                 flagship_run)

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def cloud(n=60, seed=0, zero_rest_rows=0):
    """Parameters and degrees of n Gaussians, the first ``zero_rest_rows``
    with all-zero rest coefficients (as SH culling leaves them)."""
    params, degrees = random_cloud_np(seed, n)
    params["features_rest"][:zero_rest_rows] = 0.0
    return params, degrees


def j_params(model):
    n = model.num_points
    return {k: np.asarray(v)[:n] for k, v in model.parameters().items()}


def t_params(model):
    return {k: v.detach().numpy() for k, v in model.param_dict().items()}


def to_numpy(d):
    return {k: np.array(v) for k, v in d.items()}


def assert_decided_alike(x, c):
    """Every nearest-centre decision over c either has a margin
    (``argmin_margins``) or, where the expansion's rounding decides, is made
    from distances bit-equal to the JAX package's (on the CPU they are for
    1- and 3-D values), so both packages pick the same centre."""
    if not (argmin_margins(x, c) > 1e-5).all():
        assert x.shape[1] <= 3, x.shape
        np.testing.assert_array_equal(
            PAIRWISE(torch.as_tensor(x), torch.as_tensor(c)).numpy(),
            np.asarray(jk._pairwise_sq_dists(jnp.asarray(np.asarray(x)),
                                             jnp.asarray(np.asarray(c)))))


def assert_nearest_decided_alike(model, codebooks, quantizer):
    """``assert_decided_alike`` for every attribute's nearest-codebook ids."""
    for key in quantizer.keys(model):
        cb = torch.as_tensor(codebooks[key])
        if key == "scaling":
            cb = torch.exp(cb)
        if cb.shape[0] > 1:
            assert_decided_alike(quantizer.values(model, key), cb)


# --------------------------------------------------------------- code widths
def test_code_widths_equal_jax_where_its_codes_fit():
    ns = [*range(2, 257), *range(512, 65537), *(2 ** p for p in range(1, 17))]
    for n in ns:
        assert tq.compute_uint_dtype(n) == jq.compute_uint_dtype(n), n
    assert tq.compute_uint_dtype(256) == "u1" and tq.compute_uint_dtype(65536) == "u2"


def test_code_widths_are_wider_where_jax_codes_wrap():
    for n in (257, 300, 511):
        assert (tq.compute_uint_dtype(n), jq.compute_uint_dtype(n)) == ("u2", "u1"), n
    for n in (65537, 100000, 131071):
        assert (tq.compute_uint_dtype(n), jq.compute_uint_dtype(n)) == ("u4", "u2"), n
    for n in (131072, 2 ** 20, 2 ** 32):
        assert tq.compute_uint_dtype(n) == "u4"
        assert np.iinfo(np.dtype(tq.compute_uint_dtype(n))).max >= n - 1
    assert jq.compute_uint_dtype(131072) == "u3"
    with pytest.raises(TypeError):
        np.dtype(jq.compute_uint_dtype(131072))
    with pytest.raises(ValueError):
        tq.compute_uint_dtype(2 ** 32 + 1)


def test_code_299_of_300_clusters(tmp_path):
    """300 clusters, the 300 Gaussians' opacities the 300 rows of the
    opacity codebook (one row for every other attribute): Gaussian 299
    takes code 299. The JAX package's file stores it in a u1 as 43; the
    port's stores 299 in a u2, and the JAX package reads it back right."""
    params, degrees = cloud(300, seed=1)
    params["opacity"] = np.linspace(-2.0, 2.0, 300, dtype=np.float32)[:, None]
    tm, jm = torch_model(params, degrees), jax_model(params, degrees)
    tquant = tq.VectorQuantizer(num_clusters=300)
    codebooks = {k: tquant.values(tm, k)[:1].clone() for k in tquant.keys(tm)}
    codebooks["opacity"] = torch.from_numpy(params["opacity"])
    assert_argmin_margin(tm._opacity.detach(), codebooks["opacity"])
    tquant._codebook_dict = codebooks
    jquant = jq.VectorQuantizer(num_clusters=300)
    jquant._codebook_dict = {k: jnp.asarray(v.numpy()) for k, v in codebooks.items()}
    tpath, jpath = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tquant.save_quantized(tm, tpath)
    jquant.save_quantized(jm, jpath)
    tv, jv = jquantizer.plyio.read_ply(tpath)["vertex"], jquantizer.plyio.read_ply(jpath)["vertex"]
    assert tv.dtype["opacity"] == np.dtype("u2") and jv.dtype["opacity"] == np.dtype("u1")
    np.testing.assert_array_equal(tv["opacity"], np.arange(300))
    assert int(jv["opacity"][299]) == 43
    loaded = jq.VectorQuantizer(num_clusters=300).load_quantized(JModel(3), tpath)
    np.testing.assert_array_equal(np.asarray(loaded._opacity), params["opacity"])


# ----------------------------------------------------- dequantize, nearest ids
@pytest.fixture(scope="module")
def jax_quantized():
    """A cold ExcludeZero quantization of 60 Gaussians (20 with zero rest
    coefficients) by the JAX package: (params, degrees, ids, codebooks)."""
    params, degrees = cloud(60, seed=2, zero_rest_rows=20)
    ids, cb = jq.ExcludeZeroSHQuantizer(num_clusters=16).quantize(jax_model(params, degrees))
    return params, degrees, to_numpy(ids), to_numpy(cb)


def test_dequantize_is_bit_equal_to_jax(jax_quantized):
    params, degrees, ids, cb = jax_quantized
    jm = jq.ExcludeZeroSHQuantizer().dequantize(
        jax_model(params, degrees), {k: jnp.asarray(v) for k, v in ids.items()},
        {k: jnp.asarray(v) for k, v in cb.items()})
    tm = tq.ExcludeZeroSHQuantizer().dequantize(torch_model(params, degrees), ids, cb)
    for name in PARAMS:
        np.testing.assert_array_equal(t_params(tm)[name], j_params(jm)[name], err_msg=name)
    assert not np.array_equal(t_params(tm)["scaling"], params["scaling"])
    np.testing.assert_array_equal(t_params(tm)["xyz"], params["xyz"])


def test_find_nearest_ids_match_jax(jax_quantized):
    params, degrees, _, cb = jax_quantized
    tm = torch_model(params, degrees)
    tquant = tq.ExcludeZeroSHQuantizer()
    assert_nearest_decided_alike(tm, cb, tquant)
    t_ids = tquant.find_nearest_cluster_id(tm, {k: torch.from_numpy(v) for k, v in cb.items()})
    j_ids = jq.ExcludeZeroSHQuantizer().find_nearest_cluster_id(
        jax_model(params, degrees), {k: jnp.asarray(v) for k, v in cb.items()})
    assert sorted(t_ids) == sorted(j_ids)
    for key, v in t_ids.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_ids[key]), err_msg=key)


def test_exclude_zero_pins_zero_rows():
    """Zero SH rows get id 0, whose centroid is exactly 0, non-zero rows
    never do, and the zeros survive quantize and dequantize exactly."""
    params, degrees = cloud(60, seed=3, zero_rest_rows=30)
    tm = torch_model(params, degrees)
    quant = tq.ExcludeZeroSHQuantizer(num_clusters=8, max_iter=30)
    cb, ids = quant.produce_clusters_of(tm, "features_rest_0")
    assert cb.shape == (8, 3) and not cb[0].any()
    zero_rows = (np.abs(params["features_rest"].transpose(0, 2, 1).reshape(-1, 15)[:, :3])
                 < 1e-8).all(axis=1).reshape(-1, 3)
    np.testing.assert_array_equal(ids.numpy() == 0, zero_rows)
    ids_dict, cb_dict = quant.quantize(tm)
    quant.dequantize(tm, ids_dict, cb_dict)
    assert not tm._features_rest[:30].any() and tm._features_rest[30:].abs().min() > 0


def test_exclude_zero_warm_codebook_is_cut_to_its_last_rows(monkeypatch):
    """A warm codebook of K rows seeds the K - 1 non-zero clusters with its
    last K - 1 rows (the zero centroid comes first), and draws nothing."""
    params, degrees = cloud(60, seed=4, zero_rest_rows=10)
    tm = torch_model(params, degrees)
    quant = tq.ExcludeZeroSHQuantizer(num_clusters=8)
    starts = []
    kmeans = tq.exclude_zeros.kmeans

    def record(values, k, init_centers=None, **kwargs):
        starts.append((k, init_centers))
        return kmeans(values, k, init_centers=init_centers, **kwargs)

    def no_draw(*args, **kwargs):
        raise AssertionError("k-means++ drew")

    monkeypatch.setattr(tq.exclude_zeros, "kmeans", record)
    monkeypatch.setattr(tk, "kmeanspp_init", no_draw)
    warm = torch.arange(24, dtype=torch.float32).reshape(8, 3) + 1
    cb, _ = quant.produce_clusters_of(tm, "features_rest_0", warm)
    assert starts[0][0] == 7 and torch.equal(starts[0][1], warm[1:])
    assert cb.shape == (8, 3) and not cb[0].any()


# ------------------------------------------------------------------ the files
def test_quantized_files_are_byte_identical_and_cross_load(tmp_path, jax_quantized):
    """Equal codebooks preset on both quantizers: equal bytes; each package
    loads the other's file into equal parameters."""
    params, degrees, _, cb = jax_quantized
    tm, jm = torch_model(params, degrees), jax_model(params, degrees)
    tquant, jquant = tq.ExcludeZeroSHQuantizer(num_clusters=16), \
        jq.ExcludeZeroSHQuantizer(num_clusters=16)
    assert_nearest_decided_alike(tm, cb, tquant)
    tquant._codebook_dict = {k: torch.from_numpy(v) for k, v in cb.items()}
    jquant._codebook_dict = {k: jnp.asarray(v) for k, v in cb.items()}
    tpath, jpath = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tquant.save_quantized(tm, tpath)
    jquant.save_quantized(jm, jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        t_bytes, j_bytes = f.read(), g.read()
    assert t_bytes == j_bytes
    assert os.path.getsize(tpath) < 0.5 * 60 * 62 * 4
    t_loaded = tq.ExcludeZeroSHQuantizer().load_quantized(TModel(3, device="cpu"), jpath)
    j_loaded = jq.ExcludeZeroSHQuantizer().load_quantized(JModel(3), tpath)
    assert t_loaded.num_points == j_loaded.num_points == 60
    for name in PARAMS:
        np.testing.assert_array_equal(t_params(t_loaded)[name], j_params(j_loaded)[name],
                                      err_msg=name)
    for key, v in tq.ExcludeZeroSHQuantizer().parse_codebook(
            jquantizer.plyio.read_ply(tpath), 3).items():
        np.testing.assert_array_equal(v.numpy(), cb[key].astype(np.float32), err_msg=key)


def test_load_quantized_sets_the_degrees(tmp_path, jax_quantized):
    """The JAX package's model cannot render after load_quantized (its
    degrees stay empty); the port's holds N degrees at the maximum and
    renders as the model loaded from the dequantized PLY does."""
    params, degrees, _, cb = jax_quantized
    quant = tq.ExcludeZeroSHQuantizer(num_clusters=16)
    quant._codebook_dict = {k: torch.from_numpy(v) for k, v in cb.items()}
    path = str(tmp_path / "q.ply")
    quant.save_quantized(torch_model(params, degrees), path)

    j_loaded = jq.ExcludeZeroSHQuantizer().load_quantized(JModel(3), path)
    assert np.asarray(j_loaded._degrees).shape == (0,)
    with pytest.raises(TypeError, match="incompatible shapes"):
        j_loaded.get_features

    t_loaded = tq.ExcludeZeroSHQuantizer().load_quantized(TModel(3, device="cpu"), path)
    assert t_loaded._degrees.shape == (60,) and (t_loaded._degrees == 3).all()
    t_loaded.save_ply(str(tmp_path / "dequantized.ply"))
    from_ply = TModel(3, device="cpu").load_ply(str(tmp_path / "dequantized.ply"))
    cam = torch_dataset([camera_np(32, 48)])[0]
    with torch.no_grad():
        a, b = t_loaded(cam)["render"], from_ply(cam)["render"]
    assert torch.isfinite(a).all() and a.abs().max() > 0
    assert torch.equal(a, b)


# ------------------------------------------------------------------ the hook
class RecordingQuantizer:
    """Records (curr_step, Adam's count) at each quantize call."""

    def __init__(self):
        self.calls, self.trainer = [], None

    def quantize(self, model, update_codebook=True):
        assert update_codebook
        self.calls.append((self.trainer.curr_step, int(self.trainer.engine.adam.count)))
        return {}, {}

    def dequantize(self, model, ids_dict, codebook_dict, xyz=None, replace=False):
        return model


def test_quantize_hook_fires_at_the_jax_steps_before_the_update():
    params, degrees = cloud(30, seed=5)
    cams = [camera_np(16, 16)]
    images = [np.zeros((3, 16, 16), np.float32)]
    schedule = dict(quantize_from_iter=2, quantize_until_iter=7, quantize_interval=2)
    steps = {}
    for name, pkg, trainer_cls, model, dataset in (
            ("port", tq, TBaseTrainer, torch_model(params, degrees), torch_dataset(cams, images)),
            ("jax", jq, JBaseTrainer, jax_model(params, degrees), jax_dataset(cams, images))):
        quant = RecordingQuantizer()
        trainer = pkg.QuantizeTrainerWrapper(trainer_cls(model, dataset), quant, **schedule)
        quant.trainer = trainer
        for _ in range(9):
            trainer.step(dataset[0])
        steps[name] = quant.calls
    assert steps["port"] == steps["jax"] == [(2, 2), (4, 4), (6, 6)]


def test_quantize_hook_quantizes_in_place_and_keeps_adam():
    """A read of ``model`` at a quantize step snaps every attribute to its
    codebook in place, keeps Adam's moments, and leaves xyz alone."""
    params, degrees = cloud(30, seed=6)
    tm = torch_model(params, degrees)
    ds = torch_dataset([camera_np(16, 16)], [np.zeros((3, 16, 16), np.float32)])
    trainer = tq.VectorQuantizeTrainerWrapper(TBaseTrainer(tm, ds), num_clusters=8,
                                              quantize_from_iter=2, quantize_interval=2)
    trainer.step(ds[0])
    moments = {k: v.clone() for k, v in trainer.engine.adam.m.items()}
    before = t_params(tm)
    for name, v in t_params(trainer.model).items():   # step 1: no event
        np.testing.assert_array_equal(v, before[name], err_msg=name)
    trainer.engine.curr_step = 2
    after = t_params(trainer.model)
    assert len(np.unique(after["scaling"], axis=0)) <= 8 < len(np.unique(before["scaling"], axis=0))
    assert len(np.unique(after["opacity"])) <= 8
    np.testing.assert_array_equal(after["xyz"], before["xyz"])
    for k, v in trainer.engine.adam.m.items():
        assert torch.equal(v, moments[k]), k
    assert set(trainer.quantizer._codebook_dict) == set(trainer.quantizer.keys(tm))


# ------------------------------------------------ the flagship with --quantize
QUANTIZE_CONFIG = dict(num_clusters=16, quantize_from_iter=5, quantize_interval=5)
QUANTIZE_STEPS = [5, 10]   # curr_step at each event: before steps 6 and 11


@pytest.fixture(scope="module")
def qrun():
    """tests/test_torch_pruning.py's toy run through ``prepare_trainer`` with
    ``quantize`` and ``with_scale_reg``, both quantizers preset with the
    JAX package's cold codebooks of the start; every K-Means argmin margin
    and stopping-rule margin of the port recorded."""
    from .test_torch_densification import toy_scene
    params, degrees, *_ = toy_scene(with_depth=True)
    start = jq.ExcludeZeroSHQuantizer(num_clusters=16).produce_clusters(
        jax_model(params, degrees))[0]
    presets = to_numpy(start)
    events = {"port": [], "jax": []}

    def build(prep, name, convert):
        def make(model, dataset):
            trainer, quantizer = prep.prepare_trainer(
                model, dataset, mode="densify-pruning-shculling", with_scale_reg=True,
                quantize=True, configs=dict(RUN_CONFIG, **QUANTIZE_CONFIG))
            quantizer._codebook_dict = {k: convert(v) for k, v in presets.items()}
            quantize = quantizer.quantize

            def record(model, update_codebook=True):
                events[name].append((trainer.curr_step, model.num_points))
                return quantize(model, update_codebook)

            quantizer.quantize = record
            return trainer
        return make

    near_ties, stops = [], []
    pairwise, lloyd = tk.pairwise_sq_dists, tk.lloyd

    def record_pairwise(a, b):
        d = pairwise(a, b)
        if d.shape[1] > 1 and not (argmin_margins(a, b) > 1e-5).all():
            near_ties.append((a.numpy().copy(), b.numpy().copy()))
        return d

    def record_lloyd(x, weights, init_centers, max_iter, tol):
        out = lloyd(x, weights, init_centers, max_iter, tol)
        prev, shifts = init_centers, []
        for m in range(1, out[2] + 1):
            c = lloyd(x, weights, init_centers, m, tol)[0]
            shifts.append(float(torch.sum((c - prev) ** 2)))
            prev = c
        var = torch.mean(torch.var(x, dim=0, correction=0))
        stops.append((np.array(shifts), tol * max(float(var), 1e-30), out[2], max_iter))
        return out

    def no_draw(*args, **kwargs):
        raise AssertionError("k-means++ drew")

    mp = pytest.MonkeyPatch()
    mp.setattr(tk, "pairwise_sq_dists", record_pairwise)
    mp.setattr(tk, "lloyd", record_lloyd)
    mp.setattr(tk, "kmeanspp_init", no_draw)
    mp.setattr(jk, "_kmeanspp_init", no_draw)
    try:
        run = flagship_run(build(jprepare, "jax", jnp.asarray),
                           build(tprepare, "port", torch.from_numpy))
    finally:
        mp.undo()
    return dict(run, events=events, near_ties=near_ties, stops=stops)


def test_quantizing_flagship_onion_matches_jax(qrun):
    from .test_torch_pruning import onion
    assert onion(qrun["ttr"]) == onion(qrun["jtr"])
    assert onion(qrun["ttr"])[:3] == ["QuantizeTrainerWrapper", "ScaleRegularizer", "SHCuller"]


def test_quantizing_flagship_decisions_have_margins(qrun):
    """As the plain run's, and every K-Means argmin of the port's either has
    a 1e-5 margin or, where the expansion's rounding decides (the real part
    of rotations near 1), its distances equal the JAX package's bit for
    bit, so both packages pick the same centre (on the CPU they do for 1-
    and 3-D values, not for the 5- and 7-D SH bands)."""
    check_decision_margins(qrun)
    assert qrun["near_ties"]
    for a, b in qrun["near_ties"]:
        assert_decided_alike(a, b)
    assert len(qrun["stops"]) == 2 * 8
    for shifts, tol_eff, iters, max_iter in qrun["stops"]:
        assert_decision_margin(shifts, tol_eff)
        assert iters == max_iter or shifts[-1] <= tol_eff


def test_quantizing_flagship_events_match_jax(qrun):
    """Quantize events at the same steps and N in both packages; the second
    comes after the SH cull, so ExcludeZero's path runs, warm."""
    assert [s for s, _ in qrun["events"]["port"]] == QUANTIZE_STEPS
    assert qrun["events"]["port"] == qrun["events"]["jax"]
    ttr = qrun["ttr"]
    assert not ttr.model._features_rest.detach().flatten(1).abs().amax(1).eq(0).all()
    assert len(np.unique(t_params(ttr.model)["rotation"][:, 0])) > 1


def test_quantizing_flagship_masks_and_row_counts_match_jax(qrun):
    check_masks_and_row_counts(qrun)


def test_quantizing_flagship_losses_and_state_match_jax(qrun):
    check_losses_and_state(qrun)
