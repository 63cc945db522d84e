"""PyTorch port vs JAX package: the trainer extensions.

The depth and scale terms of ``DepthSupervisor`` and ``ScaleRegularizer``
over a zero base loss, on the same seeded render outputs and parameters:
values at rtol 1e-5 and gradients at rtol 1e-4. ``OpacityResetter`` and the
step the engine passes to the loss are checked on the port's own trainer."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch import trainer as ttrainer  # noqa: E402
from reduced_3dgs_torch.trainer import extensions as text  # noqa: E402
from reduced_3dgs_tpu.trainer import extensions as jext  # noqa: E402

from .test_torch_fixtures import random_cloud_np, torch_dataset, torch_model, views_np  # noqa: E402

H, W = 24, 32


class _JaxZero:
    def loss_pure(self):
        return lambda params, aux, out, camera, extras: jnp.float32(0.0)


class _PortZero:
    def loss_pure(self):
        return lambda params, out, camera, extras: torch.zeros(())


def _depth_case(seed=101):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    final_t = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    final_t[0, :4] = 1.0                      # alpha 0: masked, finite
    gt = rng.uniform(2.0, 4.0, (H, W)).astype(np.float32)
    gt[rng.uniform(size=(H, W)) < 0.2] = 0.0
    return depth, final_t, gt


@pytest.mark.parametrize("step", [0, 7, 10, 25])
def test_depth_term_matches_jax(step):
    depth, final_t, gt = _depth_case()
    cfg = dict(depth_l1_weight_init=1.0, depth_l1_weight_final=0.01, depth_l1_weight_max_steps=10)
    j_loss = jext.DepthSupervisor(_JaxZero(), **cfg).loss_pure()
    t_loss = text.DepthSupervisor(_PortZero(), **cfg).loss_pure()

    def jf(d, t):
        return j_loss(None, None, {"depth": d, "final_T": t},
                      SimpleNamespace(ground_truth_depth=jnp.asarray(gt)),
                      {"step": jnp.int32(step)})

    jv, (jgd, jgt) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(depth),
                                                            jnp.asarray(final_t))
    d = torch.from_numpy(depth).requires_grad_(True)
    t = torch.from_numpy(final_t).requires_grad_(True)
    tv = t_loss(None, {"depth": d, "final_T": t},
                SimpleNamespace(ground_truth_depth=torch.from_numpy(gt)),
                {"step": torch.tensor(step, dtype=torch.int32)})
    tv.backward()
    assert float(tv.detach()) > 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for g, jg in ((d.grad, jgd), (t.grad, jgt)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(jg).max()))
    no_depth = t_loss(None, {"depth": d, "final_T": t},
                      SimpleNamespace(ground_truth_depth=None),
                      {"step": torch.tensor(step, dtype=torch.int32)})
    assert float(no_depth) == 0.0


def test_scale_regularizer_matches_jax():
    params, _ = random_cloud_np(102, 40, scale_lo=-6.0, scale_hi=-1.0)
    j_loss = jext.ScaleRegularizer(_JaxZero(), scale_reg_weight=0.5,
                                   scale_reg_max_ratio=3.0).loss_pure()
    t_loss = text.ScaleRegularizer(_PortZero(), scale_reg_weight=0.5,
                                   scale_reg_max_ratio=3.0).loss_pure()
    jv, jg = jax.value_and_grad(lambda s: j_loss({"scaling": s}, None, None, None, {}))(
        jnp.asarray(params["scaling"]))
    s = torch.from_numpy(params["scaling"]).requires_grad_(True)
    tv = t_loss({"scaling": s}, None, None, {})
    tv.backward()
    assert float(tv.detach()) > 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-7)


def _toy_trainer(ctor, **cfg):
    params, degrees = random_cloud_np(103, 30)
    cams = views_np(2, 24, 32)
    images = [np.full((3, 24, 32), 0.5, np.float32)] * 2
    model = torch_model(params, degrees)
    return model, ctor(model, torch_dataset(cams, images), **cfg)


def test_opacity_reset_clamps_and_zeroes_its_moments():
    model, tr = _toy_trainer(
        lambda m, ds, **cfg: text.OpacityResetTrainerWrapper(ttrainer.Trainer, m, ds, **cfg),
        opacity_reset_interval=3, opacity_reset_value=0.4, opacity_reset_until_iter=3)
    ds = tr.base_trainer.dataset
    for it in range(2):
        tr.step(ds[it % 2])
    tr.engine.optimizer_step = _capture(tr.engine)
    tr.step(ds[0])
    after = torch.sigmoid(model._opacity.detach())
    stepped = tr.engine.captured
    assert (stepped > 0.4).any() and (stepped < 0.4).any()
    np.testing.assert_allclose(after.numpy(), torch.clamp(stepped, max=0.4).numpy(), rtol=1e-5)
    adam = tr.engine.adam
    assert adam.count == 3
    assert not adam.m["opacity"].any() and not adam.v["opacity"].any()
    assert adam.m["xyz"].any() and adam.v["scaling"].any()
    tr.step(ds[1])                             # step 4: no reset
    assert adam.m["opacity"].any()


def _capture(engine):
    """optimizer_step that keeps sigmoid(opacity) just after Adam's update."""
    step = type(engine).optimizer_step

    def optimizer_step(out, offset):
        step(engine, out, offset)
        engine.captured = torch.sigmoid(engine.model._opacity.detach()).clone()
    return optimizer_step


def test_loss_sees_the_pre_increment_step():
    """extras["step"] is Adam's count before the step's update: 0, 1, 2, ...
    (the JAX engine's ``extras["step"] = adam.count``)."""
    seen = []

    class _Recorder(ttrainer.TrainerWrapper):
        def loss_pure(self):
            base = self.base_trainer.loss_pure()

            def loss(params, out, camera, extras):
                seen.append((extras["step"], self.engine.adam.count.clone()))
                return base(params, out, camera, extras)
            return loss

    model, tr = _toy_trainer(lambda m, ds: _Recorder(ttrainer.Trainer(m, ds)))
    for it in range(3):
        tr.step(tr.base_trainer.dataset[it % 2])
    assert seen == [(0, 0), (1, 1), (2, 2)] and tr.engine.adam.count == 3
    assert [float(text.depth_weight(torch.tensor(s, dtype=torch.int32), 0.0, np.log(0.01), 2))
            for s in (0, 1, 2, 3)] == pytest.approx(
        [1.0, 0.1, 0.01, 0.01], rel=1e-6)
