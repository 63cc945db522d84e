"""BaseTrainer and Trainer: the training engine (counterpart of
reduced_3dgs_tpu/trainer/base.py:33-586).

One step renders the camera from the model's parameters with a zero
screen-space offset that requires grad, takes the loss
(1 - lambda) L1 + lambda (1 - SSIM) with lambda 0.2 (plus the optional
SH-sparsity term), runs ``loss.backward()`` (the backward tile compositor
is the CUDA kernel ``composite_bwd`` on the card), applies Adam in place
and adds the offset's gradient norm to the densification statistics, in
place. Under the camera trainer the step renders through the camera moved by
its learned delta, whose gradient comes out of the same ``backward``.

The step makes no host sync: it renders through the trainer's static key
buffer (``key_buffer_for``: one size per image size, 6 N at first, as the
JAX engine sizes it), Adam's count and the xyz learning rate live on the
device, and ``_note_overflow`` reads the buffer's overflow flags and entry
counts only every 64 steps, in one transfer, to regrow or shrink it (and
snapshot a buffer that keeps overflowing, ``utils/debug.py``).

``update_many`` runs a window of steps (``AbstractTrainer.step_many``).
On the CPU it runs the same fixed-shape step once per camera. On the card
the step is captured once as a CUDA graph (``StepGraph``), after one eager
step on a side stream, and the graph is replayed once per camera, with the
camera's matrices and ground truth copied into its fixed inputs first.
One graph lives at a time: it is captured again whenever N, the key
buffer, the image size, the FoV, the active SH degree, the loss's
composition, the learning rates or any state tensor changes (an event
replaces the state's tensors). Windows of one step, trainable cameras and
cameras that differ in size or in the ground truth they carry take single
steps, as in the JAX engine, and so do cameras that differ in FoV. Both
model families' steps (3DGS and 2DGS) make no host sync and are captured.
A card that cannot capture raises.

The model keeps exactly N rows, and every Gaussian is alive. The JAX
engine's capacity padding (``pad_axis0``, ``mask_rows``) exists for XLA's
static shapes and is not ported; the key buffer is sized from the capacity
the JAX engine would hold (``bucket_capacity`` of N, raised when N outgrows
it, which forgets every size as the JAX engine's ``grow_capacity`` does), so
both engines size it alike.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.rasterize.launches import CameraGraph
from ..ops.rasterize.tiled import bucket_capacity, default_key_buffer_size, max_key_buffer
from ..ops.ssim import ssim
from ..utils import profiling
from ..utils.math import l1_loss
from ..utils.schedule import get_expon_lr_func
from .abc import AbstractTrainer
from .optimizer import AdamState, adam_init, adam_update

# Steps between two reads of the key buffer's overflow flags (JAX
# base.py:424), and the starting buffer's entries per Gaussian of capacity
# (the JAX engine's default key_buffer_factor).
KEY_BUFFER_DRAIN = 64
KEY_BUFFER_FACTOR = 6


def _tiles(camera):
    return -(-camera.image_width // 16), -(-camera.image_height // 16)


def window_psnr(render: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(max(MSE, 1e-12)) over every pixel and channel: the PSNR
    the JAX engine logs per step of a window (JAX base.py:285-288)."""
    return -10.0 * torch.log10(torch.clamp(torch.mean((render - gt) ** 2), min=1e-12))


def window_signature(camera) -> tuple:
    """What must agree across a window's cameras: the image size, the FoV
    (a captured step holds its tangents) and which ground truth each carries
    (JAX base.py:317-329, with depth maps)."""
    return (camera.image_height, camera.image_width, camera.FoVx, camera.FoVy,
            camera.ground_truth_image is None, camera.ground_truth_image_mask is None,
            camera.ground_truth_depth is None)


# The camera fields a step reads that hold tensors.
STEP_INPUT_FIELDS = ("world_view_transform", "full_proj_transform", "camera_center",
                     "bg_color", "ground_truth_image", "ground_truth_image_mask",
                     "ground_truth_depth")


class StepGraph(CameraGraph):
    """A window's step captured on ``camera`` (the counterpart of the JAX
    engine's k steps as one XLA program, JAX base.py:223-362): the
    parameters' gradients are dropped, the step runs eagerly (``first`` is
    its record, the window's first step's) and is captured with its
    gradients left in the graph's fixed tensors. ``key`` is the
    ``graph_key`` it holds fixed; ``replay(camera)`` returns a copy of the
    replayed step's record."""

    def __init__(self, engine, outer, camera, key):
        self.key = key
        for p in engine.model.param_dict().values():
            p.grad = None
        super().__init__(camera, STEP_INPUT_FIELDS, lambda cam: engine.window_step(outer, cam),
                         lambda cam: engine.window_step(outer, cam, keep_grads=True),
                         engine.model._xyz.device)

    def replay(self, camera) -> torch.Tensor:
        super().replay(camera)
        return self.out.clone()


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
        # The key buffer's size per image size, and the flags not read yet.
        self.key_capacity = bucket_capacity(n)
        self._key_buffer_size: dict = {}
        self._overflow_backlog: list = []
        self._overflow_streak = 0
        self._shrink_cooldown = 0
        self._graph: Optional[StepGraph] = None

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

    def xyz_lr_traced(self, step: torch.Tensor):
        """The xyz learning rate at Adam's count ``step`` (a 0-d device
        tensor), computed where the count lives, so that a captured step
        replays it (JAX base.py:364-376). The base rate is a constant."""
        del step
        return self.position_lr_init * self.spatial_lr_scale

    def lr_constants(self) -> tuple:
        """Every number the learning rates are computed from: a captured
        step holds them, so a change captures it again."""
        return (self.spatial_lr_scale, self.position_lr_init, self.feature_lr,
                self.opacity_lr, self.scaling_lr, self.rotation_lr)

    def maybe_advance_schedules(self):
        """Called once per step before the update (Trainer adds behaviour)."""
        return None

    def advances_at(self, step: int) -> bool:
        """Would ``maybe_advance_schedules`` change anything at the start of
        the step after ``step``? A window may not cross such a step
        (``AbstractTrainer.max_window``)."""
        return False

    def lr_tree(self, params) -> dict:
        """Learning rate of each parameter, read before Adam's count
        advances; features_rest takes feature_lr / 20."""
        lrs = {
            "xyz": self.xyz_lr_traced(self.adam.count),
            "features_dc": self.feature_lr,
            "features_rest": self.feature_lr / 20.0,
            "opacity": self.opacity_lr,
            "scaling": self.scaling_lr,
            "rotation": self.rotation_lr,
        }
        return {k: lrs.get(k, 0.0) for k in params}

    # ----------------------------------------------------------- key buffer
    def key_buffer_for(self, camera) -> int:
        """The static key buffer of ``camera``'s image size: at first the
        larger of ``default_key_buffer_size`` and ``KEY_BUFFER_FACTOR`` x the
        capacity, never more than ``max_key_buffer`` (JAX base.py:370-379)."""
        if self.model.num_points > self.key_capacity:
            self.key_capacity = bucket_capacity(self.model.num_points)
            self._key_buffer_size.clear()
        n = self.key_capacity
        tiles_x, tiles_y = _tiles(camera)
        hw = (camera.image_height, camera.image_width)
        if hw not in self._key_buffer_size:
            self._key_buffer_size[hw] = max(default_key_buffer_size(n, tiles_x, tiles_y),
                                            KEY_BUFFER_FACTOR * n)
        return min(self._key_buffer_size[hw], max_key_buffer(n, tiles_x, tiles_y))

    def held_key_buffer(self, camera) -> Optional[int]:
        """``key_buffer_for(camera)`` when the engine holds a buffer for its
        image size (it has stepped or swept at it), else None."""
        if (camera.image_height, camera.image_width) not in self._key_buffer_size:
            return None
        return self.key_buffer_for(camera)

    def set_key_buffer(self, camera, size: int):
        """The buffer of ``camera``'s image size becomes ``size``: an event
        sweep that regrew it writes it back, as the JAX package's step and
        sweeps share ``model._key_buffer_size``."""
        self._key_buffer_size[(camera.image_height, camera.image_width)] = int(size)

    def sweep_buffer(self, camera) -> dict:
        """The key buffer arguments of a static event sweep at ``camera``'s
        image size (``ops.rasterize.sweep.static_sweep``): the buffer held
        for it, and ``on_regrow``, which writes a regrown one back with
        ``set_key_buffer``."""
        return {"key_buffer": self.held_key_buffer(camera),
                "on_regrow": lambda size: self.set_key_buffer(camera, size)}

    def grow_key_buffer(self, camera):
        """Twice the buffer, up to ``max_key_buffer``."""
        profiling.count("key_buffer.regrows")
        tiles_x, tiles_y = _tiles(camera)
        self._key_buffer_size[(camera.image_height, camera.image_width)] = min(
            self.key_buffer_for(camera) * 2,
            max_key_buffer(self.key_capacity, tiles_x, tiles_y))

    def shrink_key_buffer(self, camera, max_rendered: int):
        """Down toward 1.15 x the largest entry count of the last drain,
        rounded up to a tier (multiples of 2048, each 1.15 x the last), and
        only when that is a whole tier below the buffer (JAX
        base.py:390-410)."""
        hw = (camera.image_height, camera.image_width)
        cur = self.key_buffer_for(camera)
        target = max(int(1.15 * max_rendered), 2048)
        desired = 2048
        while desired < target:
            desired = -(-int(desired * 1.15) // 2048) * 2048
        if desired < cur and int(desired * 1.15) <= cur:
            profiling.count("key_buffer.shrinks")
            self._key_buffer_size[hw] = desired

    def _note_overflow(self, out, camera, steps: int = 1):
        """Keep the step's (or window's) overflow flag and entry count on
        the device; every ``KEY_BUFFER_DRAIN`` steps read them all in one
        transfer (JAX base.py:412-462). Any overflow grows the buffer of the
        camera that overflowed first and holds shrinking off for three
        drains; the third overflowing drain in a row writes the
        ``persistent_overflow`` snapshot. A drain without overflow shrinks
        the buffer toward its largest count, unless it is cooling down."""
        if "overflow" not in out:
            return
        self._overflow_backlog.append(
            (torch.stack([out["overflow"].to(torch.float64),
                          out["num_rendered"].to(torch.float64)]), camera, steps))
        if sum(b[2] for b in self._overflow_backlog) < KEY_BUFFER_DRAIN:
            return
        with profiling.sync("overflow_drain"):
            flags, rendered = torch.stack([b[0] for b in self._overflow_backlog]).cpu().numpy().T
        profiling.count("key_buffer.drains")
        profiling.count("key_buffer.overflows", int((flags > 0).sum()))
        if flags.any():
            self.grow_key_buffer(self._overflow_backlog[int(flags.argmax())][1])
            self._shrink_cooldown = 3
            self._overflow_streak += 1
            if self._overflow_streak == 3:
                from ..utils.debug import trainer_snapshot
                trainer_snapshot(self, "persistent_overflow", camera,
                                 extra={"num_rendered_max": int(rendered.max()),
                                        "key_buffer": dict(self._key_buffer_size)})
        elif rendered.max() > 0:
            self._overflow_streak = 0
            if self._shrink_cooldown > 0:
                self._shrink_cooldown -= 1
            else:
                self.shrink_key_buffer(camera, int(rendered.max()))
        self._overflow_backlog.clear()

    # --------------------------------------------------------------- update
    def forward_loss(self, loss_fn, camera, extras):
        """Render through the key buffer with a zero [N,2] screen-space
        offset that requires grad and take the loss: (loss, render output,
        offset)."""
        with profiling.span("forward"):
            model = self.model
            offset = torch.zeros((model.num_points, 2), dtype=torch.float32,
                                 device=model._xyz.device, requires_grad=True)
            out = model.render(camera, mean2d_offset_ndc=offset,
                               key_buffer_size=self.key_buffer_for(camera))
            loss = loss_fn(model.param_dict(), out, camera, extras)
        return loss, out, offset

    @torch.no_grad()
    def optimizer_step(self, out, offset, keep_grads: bool = False):
        """After ``loss.backward()``: Adam at this step's learning rates, then
        the densification statistics from the visible Gaussians, in place,
        then the gradients are dropped, unless ``keep_grads`` (a captured
        step keeps them in the graph's fixed tensors)."""
        params = self.model.param_dict()
        adam_update(params, self.adam, self.lr_tree(params))
        radii = out["radii"]
        visible = radii > 0
        vs_norm = torch.linalg.vector_norm(offset.grad, dim=-1)
        self.xyz_grad_accum += torch.where(visible, vs_norm, torch.zeros_like(vs_norm))
        self.xyz_grad_denom += visible.to(torch.int32)
        torch.maximum(self.max_radii2d,
                      torch.where(visible, radii, torch.zeros_like(radii)).float(),
                      out=self.max_radii2d)
        if not keep_grads:
            for p in params.values():
                p.grad = None

    def _extras(self, outer) -> dict:
        """The loss's ``extras``: ``loss_scalars()`` and ``step``, a copy of
        Adam's count before this step's update (the JAX engine passes its
        pre-increment count)."""
        return dict(outer.loss_scalars(), step=self.adam.count.clone())

    def update(self, outer: AbstractTrainer, camera):
        """One step with the outermost composed loss: (loss, out), both
        detached, which the engine also keeps as ``_last_step_io_engine``
        with the camera. Under a camera trainer (``outer.camera_adjustment``)
        the render and the loss see the adjusted camera, the delta's
        gradients go back to the camera trainer, and
        ``_last_step_io_engine`` keeps the camera as given."""
        self.maybe_advance_schedules()
        extras = self._extras(outer)
        adjustment = outer.camera_adjustment(camera)
        seen = camera
        if adjustment is not None:
            cam_params, apply, consume_grads = adjustment
            seen = apply(camera, cam_params)
        loss, out, offset = self.forward_loss(outer.loss_pure(), seen, extras)
        with profiling.span("backward"):
            loss.backward()
        with profiling.span("optimizer"):
            if adjustment is not None:
                consume_grads({k: p.grad for k, p in cam_params.items()})
            self.optimizer_step(out, offset)
        self._curr_step += 1
        loss = loss.detach()
        out = {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}
        self._note_overflow(out, camera)
        self._last_step_io_engine = (loss, out, camera)
        return loss, out

    def window_step(self, outer: AbstractTrainer, camera, keep_grads: bool = False):
        """The fixed-shape step of a window, on ``camera`` as it is (no
        camera trainer): the step ``update`` takes, returning its record, a
        float64 vector of the loss, the PSNR when the camera carries ground
        truth, the overflow flag and the entry count. A CUDA graph captures
        exactly this."""
        loss, out, offset = self.forward_loss(outer.loss_pure(), camera, self._extras(outer))
        with profiling.span("backward"):
            loss.backward()
        with profiling.span("optimizer"):
            self.optimizer_step(out, offset, keep_grads=keep_grads)
        record = [loss.detach().to(torch.float64)]
        if camera.ground_truth_image is not None:
            record.append(window_psnr(out["render"].detach(), camera.ground_truth_image)
                          .to(torch.float64))
        record += [out["overflow"].to(torch.float64), out["num_rendered"].to(torch.float64)]
        return torch.stack(record)

    def graph_key(self, outer: AbstractTrainer, camera) -> tuple:
        """What a captured step holds fixed: N, the key buffer, the image
        size and FoV, the active SH degree, the loss's composition and
        scalars, the learning rates and the address of every state tensor
        the step reads or writes."""
        model = self.model
        state = [*model.param_dict().values(), *self.adam.m.values(), *self.adam.v.values(),
                 self.adam.count, self.xyz_grad_accum, self.xyz_grad_denom, self.max_radii2d,
                 *model.aux_state().values()]
        return (model.num_points, self.key_buffer_for(camera), model.active_sh_degree,
                model.scale_modifier, type(model),
                id(outer.loss_pure()), tuple(sorted(outer.loss_scalars().items())),
                window_signature(camera), self.lr_constants(),
                tuple(t.data_ptr() for t in state))

    def update_many(self, outer: AbstractTrainer, cameras):
        """``len(cameras)`` steps, with no hook between them (the caller
        sizes the window with ``max_window``): (losses, ys), the k per-step
        losses as 0-d device tensors and ys = {"loss": losses, and "psnr":
        k 0-d tensors when every camera carries ground truth}. See the
        module docstring for the CPU, graph and single-step paths."""
        k = len(cameras)
        if (k == 1 or any(window_signature(c) != window_signature(cameras[0])
                          for c in cameras[1:])
                or outer.camera_adjustment(cameras[0]) is not None):
            return self._single_steps(outer, cameras)
        self.maybe_advance_schedules()
        if self.model._xyz.device.type == "cuda":
            key = self.graph_key(outer, cameras[0])
            if self._graph is None or self._graph.key != key:
                self._graph = None          # frees the old graph's pool first
                self._graph = StepGraph(self, outer, cameras[0], key)
                records = [self._graph.first]
            else:
                records = [self._graph.replay(cameras[0])]
            records += [self._graph.replay(c) for c in cameras[1:]]
            for p in self.model.param_dict().values():
                p.grad = None
        else:
            records = [self.window_step(outer, c) for c in cameras]
        table = torch.stack(records)                                  # [k, 3 or 4]
        losses = list(table[:, 0].to(torch.float32).unbind(0))
        ys = {"loss": losses}
        if cameras[0].ground_truth_image is not None:
            ys["psnr"] = list(table[:, 1].to(torch.float32).unbind(0))
        self._curr_step += k
        window = {"overflow": table[:, -2].max() > 0, "num_rendered": table[:, -1].max()}
        self._note_overflow(window, cameras[-1], steps=k)
        self._last_step_io_engine = (losses[-1], window, cameras[-1])
        return losses, ys

    def _image_camera(self, camera):
        """The camera of the image that ``update``'s output holds."""
        return camera

    def _single_steps(self, outer: AbstractTrainer, cameras):
        """The JAX engine's fallback: one ``update`` per camera, the PSNRs
        only when every camera carries ground truth."""
        losses, psnrs = [], []
        for camera in cameras:
            loss, out = self.update(outer, camera)
            losses.append(loss)
            gt = self._image_camera(camera).ground_truth_image
            if gt is not None:
                psnrs.append(window_psnr(out["render"], gt))
        ys = {"loss": losses}
        if len(psnrs) == len(cameras):
            ys["psnr"] = psnrs
        return losses, ys

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
        """The log-lerp rate at the current step on the host, scaled by the
        current ``spatial_lr_scale``, which a checkpoint may set."""
        return get_expon_lr_func(
            lr_init=self.position_lr_init * self.spatial_lr_scale,
            lr_final=self.position_lr_final * self.spatial_lr_scale,
            lr_delay_mult=self.position_lr_delay_mult,
            max_steps=self.position_lr_max_steps)(self._curr_step)

    def xyz_lr_traced(self, step: torch.Tensor) -> torch.Tensor:
        """The log-lerp rate at Adam's count ``step`` in float32 on the
        device, as the JAX engine computes it in its step (JAX
        base.py:566-576; no delay ramp)."""
        lr_init = self.position_lr_init * self.spatial_lr_scale
        lr_final = self.position_lr_final * self.spatial_lr_scale
        t = torch.clamp(step.to(torch.float32) / self.position_lr_max_steps, 0.0, 1.0)
        return torch.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)

    def lr_constants(self) -> tuple:
        return super().lr_constants() + (self.position_lr_final, self.position_lr_max_steps)

    def maybe_advance_schedules(self):
        if (self._curr_step > 0
                and self._curr_step % self.sh_degree_up_interval == 0
                and self.model.active_sh_degree < self.model.max_sh_degree):
            self.model.active_sh_degree += 1

    def advances_at(self, step: int) -> bool:
        return (step > 0 and step % self.sh_degree_up_interval == 0
                and self.model.active_sh_degree < self.model.max_sh_degree)
