"""Trainable cameras, the ``camera-*`` modes (counterpart of
reduced_3dgs_tpu/trainer/camera_trainer.py:1-92).

Each camera gets a learned SE(3) delta, a quaternion ``rot`` and a
translation ``trans``, applied in view space:

  q' = q / max(|q|, 1e-12),  D = [[R(q')^T, 0], [trans, 1]]  (row-vector storage),
  world_view' = world_view @ D,  full_proj' = world_view' @ P,
  camera_center' = inv(world_view')[3, :3].

The engine renders through the adjusted camera, so ``loss.backward()``
carries the image's gradient through the preprocess into the two matrices
and the centre, and on into the delta; the backward compositor
(``composite_bwd`` on the card) is where it starts. Each camera's delta has
its own Adam (betas 0.9/0.999, eps 1e-15) at ``camera_rotation_lr`` and
``camera_position_lr``, with no schedule.

P is the camera's own projection matrix (``Camera.projection_matrix``, kept
by ``build_camera``), where the JAX package recovers it each step by an LU
solve of (world_view, full_proj). The two agree within 1e-6
(tests/test_torch_camera_trainer.py); the stored matrix needs no solve on
the card, and an unmoved delta gives back the camera bit for bit, as does a
cameras.json of the learned pose read back by ``prepare_dataset``. The
centre takes ``torch.linalg.inv_ex``, which, unlike ``inv``, does not
synchronise with the host to check for a singular matrix (a rigid
transform never is).

Slots are keyed by ``id(camera)``, as in the JAX package, so each view must
stay one object: ``CameraDataset`` hands out its stored cameras. A slot
holds its camera, so the id cannot be reused while the slot lives. Its
tensors lie on the model's device. The events (the importance sweep, the SH
cull, the mercy prune, the scene extent) read the dataset's cameras, the
start poses, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..dataset.camera import Camera
from ..ops import projection as proj
from .abc import AbstractTrainer, TrainerWrapper
from .optimizer import AdamState, adam_count, adam_init, adam_update


def _apply_camera_delta(camera: Camera, cam_params: Dict[str, torch.Tensor]) -> Camera:
    """``camera`` moved by the delta ``cam_params`` ({"rot" [4], "trans"
    [3]}), differentiably; R and T are the new world_view's blocks."""
    q = cam_params["rot"]
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    t = cam_params["trans"]
    rot_t = proj.quat_to_rotmat(q).T
    D = torch.cat([torch.cat([rot_t, torch.zeros_like(rot_t[:, :1])], dim=1),
                   torch.cat([t, torch.ones_like(t[:1])])[None]], dim=0)
    world_view = camera.world_view_transform @ D
    return dataclasses.replace(
        camera, R=world_view[:3, :3], T=world_view[3, :3], world_view_transform=world_view,
        full_proj_transform=world_view @ camera.projection_matrix,
        camera_center=torch.linalg.inv_ex(world_view).inverse[3, :3])


class CameraTrainer(TrainerWrapper):
    """Learns a pose delta for every camera it is stepped on."""

    def __init__(self, base_trainer: AbstractTrainer, dataset=None,
                 camera_position_lr: float = 1e-4, camera_rotation_lr: float = 1e-4):
        super().__init__(base_trainer)
        self.camera_dataset = dataset
        self.camera_position_lr = camera_position_lr
        self.camera_rotation_lr = camera_rotation_lr
        self._cameras: Dict[int, Camera] = {}
        self._cam_params: Dict[int, Dict[str, torch.Tensor]] = {}
        self._cam_adam: Dict[int, AdamState] = {}

    def _slot(self, camera: Camera) -> int:
        key = id(camera)
        if key not in self._cam_params:
            device = self.model._xyz.device
            self._cameras[key] = camera
            self._cam_params[key] = {
                "rot": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device, requires_grad=True),
                "trans": torch.zeros(3, device=device, requires_grad=True),
            }
            self._cam_adam[key] = adam_init(self._cam_params[key])
        return key

    # Engine hook ----------------------------------------------------------
    def camera_adjustment(self, camera: Camera):
        """(delta tensors that require grad, the function that applies them,
        the function that takes their gradients and steps their Adam)."""
        key = self._slot(camera)

        def consume_grads(grads: Dict[str, torch.Tensor]):
            """Step the slot's Adam on ``grads``, which are the delta
            leaves' own ``.grad`` as ``backward`` left them, then drop
            them."""
            params = self._cam_params[key]
            assert all(grads[k] is p.grad for k, p in params.items())
            adam_update(params, self._cam_adam[key],
                        {"rot": self.camera_rotation_lr, "trans": self.camera_position_lr})
            for p in params.values():
                p.grad = None

        return self._cam_params[key], _apply_camera_delta, consume_grads

    @torch.no_grad()
    def adjusted_camera(self, camera: Camera) -> Camera:
        """The camera with its current learned delta applied."""
        key = self._slot(camera)
        return _apply_camera_delta(camera, self._cam_params[key])

    # Weights carried across ------------------------------------------------
    def load_numpy(self, params: Dict[int, dict], adam: Dict[int, dict]):
        """Set the slots of the views of ``camera_dataset`` from the JAX
        trainer's ``_cam_params`` and ``_cam_adam``, as numpy and keyed by
        view index: ``params[i]`` = {"rot", "trans"} and ``adam[i]`` =
        {"count", "m", "v"}, ``m`` and ``v`` keyed as ``params[i]``."""
        device = self.model._xyz.device

        def tensor(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        for i, p in params.items():
            key = self._slot(self.camera_dataset[i])
            self._cam_params[key] = {k: tensor(v).requires_grad_(True) for k, v in p.items()}
            s = adam[i]
            self._cam_adam[key] = AdamState(count=adam_count(int(s["count"]), device),
                                            m={k: tensor(v) for k, v in s["m"].items()},
                                            v={k: tensor(v) for k, v in s["v"].items()})
        return self


def CameraTrainerWrapper(base_trainer_constructor, model, dataset,
                         camera_position_lr: float = 1e-4, camera_rotation_lr: float = 1e-4,
                         **configs):
    return CameraTrainer(base_trainer_constructor(model, dataset, **configs), dataset,
                         camera_position_lr=camera_position_lr,
                         camera_rotation_lr=camera_rotation_lr)
