"""PyTorch port vs JAX package: failure snapshots (utils/debug.py).

  * ``trainer_snapshot`` of the same trainer state (the toy scene of
    tests/test_torch_densification.py, 80 Gaussians, two steps of the JAX
    package's Trainer, carried to the port by its checkpoint) writes the
    JAX package's keys, and each array equals the JAX snapshot's live rows;
    the camera's matrices, built by each package, agree within 1e-6.
  * ``training`` on a non-finite loss writes the snapshot and raises;
    ``R3DGS_SNAPSHOT_DIR=0`` turns snapshots off.
"""
import glob

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer as TTrainer  # noqa: E402
from reduced_3dgs_torch.trainer.checkpoint import load_checkpoint as t_load_checkpoint  # noqa: E402
from reduced_3dgs_torch.utils import debug as tdebug  # noqa: E402
from reduced_3dgs_tpu.trainer import Trainer as JTrainer  # noqa: E402
from reduced_3dgs_tpu.trainer.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from reduced_3dgs_tpu.utils import debug as jdebug  # noqa: E402

from .test_torch_densification import toy_scene  # noqa: E402
from .test_torch_fixtures import jax_dataset, jax_model, torch_dataset, torch_model  # noqa: E402


@pytest.fixture(autouse=True)
def snapshots(tmp_path, monkeypatch):
    monkeypatch.setenv("R3DGS_SNAPSHOT_DIR", str(tmp_path / "snapshots"))
    monkeypatch.setattr(tdebug, "_written", 0)
    monkeypatch.setattr(jdebug, "_written", 0)
    return tmp_path / "snapshots"


def test_snapshot_keys_and_arrays_match_jax(snapshots, tmp_path):
    params, degrees, cams, images = toy_scene()
    jds, tds = jax_dataset(cams, images), torch_dataset(cams, images)
    jtr = JTrainer(jax_model(params, degrees), jds, sh_degree_up_interval=1)
    for i in (0, 1):
        jtr.step(jds[i])
    # The same state in the port: the JAX trainer's checkpoint, loaded.
    j_save_checkpoint(jtr, str(tmp_path / "state.npz"))
    ttr = t_load_checkpoint(TTrainer(torch_model(params, degrees), tds),
                            str(tmp_path / "state.npz"))
    extra = {"step": 2, "loss": 0.25}
    jpath = jdebug.trainer_snapshot(jtr.engine, "jax", jds[1], extra=extra)
    tpath = tdebug.trainer_snapshot(ttr.engine, "port", tds[1], extra=extra)
    assert sorted(glob.glob(str(snapshots / "*.npz"))) == sorted([jpath, tpath])
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(t.files) == sorted(j.files)
        assert {"params/xyz", "aux/degrees", "n_alive", "xyz_grad_accum", "adam/0",
                "adam/1/xyz", "adam/2/opacity", "camera/world_view_transform",
                "extra/step"} <= set(t.files)
        n = int(t["n_alive"])
        assert n == int(j["n_alive"]) == len(degrees) and int(t["adam/0"]) == 2
        for k in t.files:
            jv, tv = j[k], t[k]
            if k.startswith("camera/"):
                np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6, err_msg=k)
                continue
            if jv.ndim and jv.shape[0] > n:
                jv = jv[:n]  # the JAX engine pads its rows to a capacity
            np.testing.assert_array_equal(tv, jv, err_msg=k)


def test_training_dumps_and_raises_on_a_non_finite_loss(snapshots, tmp_path):
    params, degrees, cams, images = toy_scene()
    params = dict(params, features_dc=np.full_like(params["features_dc"], np.nan))
    tds = torch_dataset(cams, images)
    model = torch_model(params, degrees)
    trainer = TTrainer(model, tds)
    with pytest.raises(RuntimeError, match="non-finite loss nan at step 1; state dumped to"):
        ttrain.training(tds, model, trainer, None, str(tmp_path / "out"), iteration=3,
                        save_iterations=[], device="cpu", log_interval=1)
    (path,) = glob.glob(str(snapshots / "nonfinite_loss_*.npz"))
    with np.load(path) as snap:
        assert int(snap["extra/step"]) == 1 and np.isnan(float(snap["extra/loss"]))
        assert np.isnan(snap["params/features_dc"]).all()
        assert snap["params/xyz"].shape == (len(degrees), 3)
        assert int(snap["camera/image_height"]) == cams[0]["height"]


def test_snapshots_off(monkeypatch, snapshots):
    monkeypatch.setenv("R3DGS_SNAPSHOT_DIR", "0")
    assert tdebug.snapshot_dir() is None
    assert tdebug.dump_failure_snapshot("x", {"a": torch.zeros(2)}) is None
    monkeypatch.setenv("R3DGS_SNAPSHOT_DIR", str(snapshots))
    monkeypatch.setattr(tdebug, "_written", tdebug.MAX_SNAPSHOTS)
    assert tdebug.dump_failure_snapshot("x", {"a": torch.zeros(2)}) is None
    assert not snapshots.exists()
