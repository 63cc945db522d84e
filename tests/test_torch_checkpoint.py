"""The port's training-state checkpoints (trainer/checkpoint.py).

  * A port checkpoint resumes bit-exactly on the CPU (as
    tests/test_checkpoint.py holds the JAX package's).
  * The file has the JAX package's keys and metadata, with capacity N.
  * A JAX checkpoint (groups padded to the JAX engine's capacity) loads into
    the port, and the port's continuation equals the JAX package's own
    within the step bars: parameters rtol 2e-3 / atol 3e-5, losses 1e-4.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.trainer import Trainer as TTrainer  # noqa: E402
from reduced_3dgs_torch.trainer.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from reduced_3dgs_tpu.trainer import Trainer as JTrainer  # noqa: E402
from reduced_3dgs_tpu.trainer import checkpoint as jcheckpoint  # noqa: E402

from .test_torch_densification import toy_scene  # noqa: E402
from .test_torch_fixtures import jax_dataset, jax_model, torch_dataset, torch_model  # noqa: E402

CONFIG = dict(sh_degree_up_interval=2)
FIRST, THEN = 4, 3


def t_state(trainer):
    return {g: {k: v.detach().clone() for k, v in t.items()}
            for g, t in trainer.engine.state_trees().items()}


def test_port_checkpoint_resumes_bit_exactly(tmp_path):
    params, degrees, cams, images = toy_scene()
    ds = torch_dataset(cams, images)
    tr_a = TTrainer(torch_model(params, degrees), ds, **CONFIG)
    for i in range(FIRST):
        tr_a.step(ds[i % 3])
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(tr_a, path)
    degree = tr_a.model.active_sh_degree
    losses_a = [float(tr_a.step(ds[i % 3])[0]) for i in range(FIRST, FIRST + THEN)]

    other = {k: v + np.float32(0.5) for k, v in params.items()}
    tr_b = TTrainer(torch_model(other, np.zeros_like(degrees)), ds, spatial_lr_scale=9.0,
                    **CONFIG)
    load_checkpoint(tr_b, path)
    assert tr_b.curr_step == FIRST and tr_b.adam.count == FIRST
    assert tr_b.model.active_sh_degree == degree == 1
    assert tr_b.spatial_lr_scale == tr_a.spatial_lr_scale
    losses_b = [float(tr_b.step(ds[i % 3])[0]) for i in range(FIRST, FIRST + THEN)]
    assert losses_b == losses_a
    a, b = t_state(tr_a), t_state(tr_b)
    for group in a:
        for k in a[group]:
            assert torch.equal(a[group][k], b[group][k]), (group, k)


def test_checkpoint_format_matches_jax(tmp_path):
    params, degrees, cams, images = toy_scene()
    t = TTrainer(torch_model(params, degrees), torch_dataset(cams, images), **CONFIG)
    j = JTrainer(jax_model(params, degrees), jax_dataset(cams, images), **CONFIG)
    t.step(t.dataset[0])
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_checkpoint(t, tpath)
    jcheckpoint.save_checkpoint(j, jpath)
    with np.load(tpath) as td, np.load(jpath) as jd:
        assert sorted(td.files) == sorted(jd.files)
        tmeta, jmeta = json.loads(str(td["__meta__"])), json.loads(str(jd["__meta__"]))
        assert sorted(tmeta) == sorted(jmeta)
        n = len(params["xyz"])
        assert tmeta["capacity"] == tmeta["n_alive"] == n == jmeta["n_alive"]
        assert jmeta["capacity"] > n
        for key in td.files:
            if key != "__meta__":
                assert td[key].dtype == jd[key].dtype, key
                assert td[key].shape[1:] == jd[key].shape[1:], key


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    params, degrees, cams, images = toy_scene()
    jds = jax_dataset(cams, images)
    j = JTrainer(jax_model(params, degrees), jds, **CONFIG)
    for i in range(FIRST):
        j.step(jds[i % 3])
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(j, path)
    j_losses = [float(j.step(jds[i % 3])[0]) for i in range(FIRST, FIRST + THEN)]

    tds = torch_dataset(cams, images)
    t = TTrainer(torch_model(params, np.zeros_like(degrees)), tds, **CONFIG)
    load_checkpoint(t, path)
    assert t.model.num_points == len(params["xyz"]) and t.curr_step == FIRST
    np.testing.assert_array_equal(t.model._degrees.numpy(), degrees)
    t_losses = [float(t.step(tds[i % 3])[0]) for i in range(FIRST, FIRST + THEN)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    n = int(j.engine.n_alive)
    jp = {k: np.asarray(v)[:n] for k, v in j.model.parameters().items()}
    for k, v in t.model.param_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), jp[k], rtol=2e-3, atol=3e-5, err_msg=k)
