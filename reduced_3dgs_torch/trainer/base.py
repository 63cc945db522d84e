"""BaseTrainer and Trainer: the training engine (counterpart of
reduced_3dgs_tpu/trainer/base.py:33-221, 465-519, 531-586).

One step renders the camera from the model's parameters with a zero
screen-space offset that requires grad, takes the loss
(1 - lambda) L1 + lambda (1 - SSIM) with lambda 0.2 (plus the optional
SH-sparsity term), runs ``loss.backward()`` (the backward tile compositor
is the CUDA kernel ``composite_bwd`` on the card), applies Adam in place
and adds the offset's gradient norm to the densification statistics.
Under the camera trainer the step renders through the camera moved by its
learned delta, whose gradient comes out of the same ``backward``.

The model keeps exactly N rows, and every Gaussian is alive. The JAX
engine's capacity padding (``functional.bucket_capacity``, ``pad_axis0``,
``mask_rows``), its static key-buffer sizing and regrowth, and its fused
multi-step windows (``step_many``, ``update_many``) exist for XLA's static
shapes and for dispatch over the remote TPU link, and are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.ssim import ssim
from ..utils.math import l1_loss
from ..utils.schedule import get_expon_lr_func
from .abc import AbstractTrainer
from .optimizer import AdamState, adam_init, adam_update


class BaseTrainer(AbstractTrainer):
    """Engine trainer with fixed learning rates."""

    def __init__(
        self, model, dataset=None, *,
        spatial_lr_scale: Optional[float] = None,
        lambda_dssim: float = 0.2,
        position_lr_init: float = 0.00016,
        feature_lr: float = 0.0025,
        opacity_lr: float = 0.05,
        scaling_lr: float = 0.005,
        rotation_lr: float = 0.001,
        lambda_sh_sparsity: float = 0.0,
        **unused_configs,
    ):
        self._model = model
        self.dataset = dataset
        if spatial_lr_scale is None:
            if dataset is not None and len(dataset) > 0:
                spatial_lr_scale = dataset.scene_extent()
            else:
                spatial_lr_scale = getattr(model, "spatial_lr_scale", 1.0)
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.lambda_dssim = lambda_dssim
        self.position_lr_init = position_lr_init
        self.feature_lr = feature_lr
        self.opacity_lr = opacity_lr
        self.scaling_lr = scaling_lr
        self.rotation_lr = rotation_lr
        self.lambda_sh_sparsity = lambda_sh_sparsity
        self._curr_step = 0
        self._photometric_loss = None
        # (loss, render output, camera) of the last step, detached: the
        # densifier chain reads it after the step.
        self._last_step_io_engine = None

        n = model.num_points
        device = model._xyz.device
        self.adam: AdamState = adam_init(model.param_dict())
        self.xyz_grad_accum = torch.zeros((n,), dtype=torch.float32, device=device)
        self.xyz_grad_denom = torch.zeros((n,), dtype=torch.int32, device=device)
        self.max_radii2d = torch.zeros((n,), dtype=torch.float32, device=device)

    # ------------------------------------------------------------------ api
    @property
    def engine(self):
        return self

    @property
    def model(self):
        return self._model

    @property
    def curr_step(self) -> int:
        return self._curr_step

    @curr_step.setter
    def curr_step(self, v: int):
        self._curr_step = int(v)

    # ----------------------------------------------------------------- loss
    def loss_pure(self):
        if self._photometric_loss is None:
            lam = self.lambda_dssim
            lam_sh = self.lambda_sh_sparsity

            def photometric(params, out, camera, extras):
                del extras
                render = out["render"]
                gt = camera.ground_truth_image
                if camera.ground_truth_image_mask is not None:
                    render = render * camera.ground_truth_image_mask
                    gt = gt * camera.ground_truth_image_mask
                loss = (1.0 - lam) * l1_loss(render, gt) + lam * (1.0 - ssim(render, gt))
                if lam_sh > 0.0:
                    # L1 SH sparsity: the reference's lambda' sign(sh)
                    # gradient per visible Gaussian, lambda' = lambda /
                    # (visible * 15 * 3), as the gradient of an explicit term.
                    rest = params["features_rest"]
                    visible = torch.sum((out["radii"] > 0).to(torch.float32))
                    denom = torch.clamp(visible, min=1.0) * rest.shape[1] * 3
                    loss = loss + lam_sh * torch.sum(torch.abs(rest)) / denom
                return loss

            self._photometric_loss = photometric
        return self._photometric_loss

    # ------------------------------------------------------------ schedules
    def xyz_lr(self) -> float:
        return self.position_lr_init * self.spatial_lr_scale

    def maybe_advance_schedules(self):
        """Called once per step before the update (Trainer adds behaviour)."""
        return None

    def lr_tree(self, params) -> dict:
        """Learning rate of each parameter; features_rest takes
        feature_lr / 20."""
        lrs = {
            "xyz": self.xyz_lr(),
            "features_dc": self.feature_lr,
            "features_rest": self.feature_lr / 20.0,
            "opacity": self.opacity_lr,
            "scaling": self.scaling_lr,
            "rotation": self.rotation_lr,
        }
        return {k: lrs.get(k, 0.0) for k in params}

    # --------------------------------------------------------------- update
    def forward_loss(self, loss_fn, camera, extras):
        """Render with a zero [N,2] screen-space offset that requires grad
        and take the loss: (loss, render output, offset)."""
        model = self.model
        offset = torch.zeros((model.num_points, 2), dtype=torch.float32,
                             device=model._xyz.device, requires_grad=True)
        out = model.render(camera, mean2d_offset_ndc=offset)
        loss = loss_fn(model.param_dict(), out, camera, extras)
        return loss, out, offset

    @torch.no_grad()
    def optimizer_step(self, out, offset):
        """After ``loss.backward()``: Adam at this step's learning rates, then
        the densification statistics from the visible Gaussians, then the
        gradients are dropped."""
        params = self.model.param_dict()
        adam_update(params, self.adam, self.lr_tree(params))
        radii = out["radii"]
        visible = radii > 0
        vs_norm = torch.linalg.vector_norm(offset.grad, dim=-1)
        self.xyz_grad_accum += torch.where(visible, vs_norm, torch.zeros_like(vs_norm))
        self.xyz_grad_denom += visible.to(torch.int32)
        self.max_radii2d = torch.maximum(
            self.max_radii2d, torch.where(visible, radii, torch.zeros_like(radii)).float())
        for p in params.values():
            p.grad = None

    def update(self, outer: AbstractTrainer, camera):
        """One step with the outermost composed loss: (loss, out), both
        detached, which the engine also keeps as ``_last_step_io_engine``
        with the camera. The loss's ``extras`` are ``loss_scalars()`` and
        ``step``, Adam's count before this step's update (as the JAX engine
        passes its pre-increment count). Under a camera trainer
        (``outer.camera_adjustment``) the render and the loss see the
        adjusted camera, the delta's gradients go back to the camera
        trainer, and ``_last_step_io_engine`` keeps the camera as given."""
        self.maybe_advance_schedules()
        extras = dict(outer.loss_scalars(), step=self.adam.count)
        adjustment = outer.camera_adjustment(camera)
        seen = camera
        if adjustment is not None:
            cam_params, apply, consume_grads = adjustment
            seen = apply(camera, cam_params)
        loss, out, offset = self.forward_loss(outer.loss_pure(), seen, extras)
        loss.backward()
        if adjustment is not None:
            consume_grads({k: p.grad for k, p in cam_params.items()})
        self.optimizer_step(out, offset)
        self._curr_step += 1
        loss = loss.detach()
        out = {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}
        self._last_step_io_engine = (loss, out, camera)
        return loss, out

    # -------------------------------------------------- densification plumbing
    def state_trees(self) -> dict:
        """Every per-Gaussian [N, ...] tensor that must move together when
        rows are removed, by group: the parameters, Adam's moments, the
        model's aux state and the densification statistics."""
        return {
            "params": {k: p.detach() for k, p in self.model.param_dict().items()},
            "adam_m": self.adam.m,
            "adam_v": self.adam.v,
            "aux": self.model.aux_state(),
            "accum": {
                "xyz_grad_accum": self.xyz_grad_accum,
                "denom": self.xyz_grad_denom,
                "max_radii2d": self.max_radii2d,
            },
        }

    def set_state_trees(self, trees: dict):
        """Install ``state_trees``-shaped state: new parameters, Adam moments
        (the step count is kept), aux state and statistics."""
        self.model.set_parameters(trees["params"])
        self.adam = AdamState(count=self.adam.count, m=trees["adam_m"], v=trees["adam_v"])
        self.model.aux_set(trees["aux"])
        self.xyz_grad_accum = trees["accum"]["xyz_grad_accum"]
        self.xyz_grad_denom = trees["accum"]["denom"]
        self.max_radii2d = trees["accum"]["max_radii2d"]

    def reset_densification_stats(self):
        self.xyz_grad_accum.zero_()
        self.xyz_grad_denom.zero_()
        self.max_radii2d.zero_()


class Trainer(BaseTrainer):
    """BaseTrainer plus the vanilla schedules: exponential (log-lerp) xyz
    learning-rate decay and the SH-degree warm-up, one band every
    ``sh_degree_up_interval`` steps from degree 0."""

    def __init__(self, model, dataset=None, *,
                 position_lr_init: float = 0.00016,
                 position_lr_final: float = 0.0000016,
                 position_lr_delay_mult: float = 0.01,
                 position_lr_max_steps: int = 30_000,
                 sh_degree_up_interval: int = 1000,
                 **configs):
        super().__init__(model, dataset, position_lr_init=position_lr_init, **configs)
        self.position_lr_final = position_lr_final
        self.position_lr_delay_mult = position_lr_delay_mult
        self.position_lr_max_steps = position_lr_max_steps
        self.sh_degree_up_interval = sh_degree_up_interval
        model.active_sh_degree = 0

    def xyz_lr(self) -> float:
        """The log-lerp rate at the current step (read before the step
        counter advances, as the JAX engine reads its Adam count), scaled
        by the current ``spatial_lr_scale``, which a checkpoint may set."""
        return get_expon_lr_func(
            lr_init=self.position_lr_init * self.spatial_lr_scale,
            lr_final=self.position_lr_final * self.spatial_lr_scale,
            lr_delay_mult=self.position_lr_delay_mult,
            max_steps=self.position_lr_max_steps)(self._curr_step)

    def maybe_advance_schedules(self):
        if (self._curr_step > 0
                and self._curr_step % self.sh_degree_up_interval == 0
                and self.model.active_sh_degree < self.model.max_sh_degree):
            self.model.active_sh_degree += 1
