"""Vanilla-3DGS clone and split densification (counterpart of
reduced_3dgs_tpu/trainer/densifier/split_clone.py:45-150).

Every ``densify_interval`` steps in [densify_from_iter, densify_until_iter],
a Gaussian is hot when its mean screen-space gradient, accum / denom over
the steps that saw it (0 when none did), is at least
``densify_grad_threshold``. A hot Gaussian is cloned when its largest scale
is at most percent_dense * scene_extent, and otherwise split: it is removed
and replaced by ``densify_n_split`` copies at xyz + R (samples * scales),
with scales divided by 0.8 * densify_n_split. The densification statistics
are reset before the instruction returns, so a pruner that wraps this one
reads zeroed statistics at such a step (as the JAX package and vanilla 3DGS
do).

The samples are standard normal draws from a ``torch.Generator`` on the
model's device, seeded from (seed, step): reproducible, and different at
every event. The JAX package draws ``jax.random.normal`` from a key folded
with the step, which the port cannot reproduce; ``densify_and_prune`` takes
the draw as an optional argument instead.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...utils import profiling
from .abc import AbstractDensifier, AppendSpec, DensificationInstruction, DensifierWrapper


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """[N,3,3] rotation matrices of quaternions (r, x, y, z) [N,4],
    normalised by max(|q|, 1e-12) (the JAX package's
    ``_build_rotation_jnp``, not the renderer's rsqrt(|q|^2 + 1e-24))."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def duplicate_values(params, copies: int):
    """AppendSpec values that repeat each source row ``copies`` times
    (views, no copy)."""
    return {k: v[:, None].expand((v.shape[0], copies) + tuple(v.shape[1:]))
            for k, v in params.items()}


class SplitCloneDensifier(DensifierWrapper):

    def __init__(self, base_densifier: AbstractDensifier, scene_extent: float,
                 densify_from_iter: int = 500,
                 densify_until_iter: int = 15000,
                 densify_interval: int = 100,
                 densify_grad_threshold: float = 0.0002,
                 densify_percent_dense: float = 0.01,
                 densify_n_split: int = 2,
                 seed: int = 0):
        super().__init__(base_densifier)
        self.scene_extent = float(scene_extent)
        self.densify_from_iter = densify_from_iter
        self.densify_until_iter = densify_until_iter
        self.densify_interval = densify_interval
        self.densify_grad_threshold = densify_grad_threshold
        self.densify_percent_dense = densify_percent_dense
        self.densify_n_split = densify_n_split
        self.seed = seed

    def draw_samples(self, n: int, step: int) -> torch.Tensor:
        """[n, densify_n_split, 3] standard normal samples of the event at
        ``step``, from a generator on the model's device seeded from
        (seed, step)."""
        device = self.model._xyz.device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence([self.seed, step]).generate_state(1)[0]))
        return torch.randn((n, self.densify_n_split, 3), generator=gen, device=device)

    def fires(self, step: int) -> bool:
        return (self.densify_from_iter <= step <= self.densify_until_iter
                and step % self.densify_interval == 0)


    def fires_at(self, step: int) -> bool:
        return self.fires(step) or super().fires_at(step)

    @torch.no_grad()
    def densify_and_prune(self, loss, out, camera, step: int,
                          samples: Optional[torch.Tensor] = None) -> DensificationInstruction:
        """At a densify step: the clone and split AppendSpecs and the split
        sources ORed into the removal mask, with the statistics reset.
        ``samples`` [N, densify_n_split, 3] replaces the event's own draw."""
        ret = super().densify_and_prune(loss, out, camera, step)
        if not self.fires(step):
            return ret
        with profiling.span("event.split_clone"):
            engine = self.trainer.engine
            params = {k: p.detach() for k, p in engine.model.param_dict().items()}
            n, k = params["xyz"].shape[0], self.densify_n_split
            denom = engine.xyz_grad_denom
            grads = torch.where(denom > 0, engine.xyz_grad_accum / torch.clamp(denom, min=1),
                                torch.zeros_like(engine.xyz_grad_accum))
            scales = torch.exp(params["scaling"])                         # [N,3]
            max_scaling = torch.max(scales, dim=1).values
            hot = grads >= self.densify_grad_threshold
            limit = self.densify_percent_dense * self.scene_extent
            clone_sel = hot & (max_scaling <= limit)
            split_sel = hot & (max_scaling > limit)

            if samples is None:
                samples = self.draw_samples(n, step)
            samples = samples * scales[:, None, :]
            offsets = torch.einsum("nij,nkj->nki", build_rotation(params["rotation"]), samples)
            split_vals = duplicate_values(params, k)
            split_vals["xyz"] = params["xyz"][:, None, :] + offsets
            split_vals["scaling"] = torch.log(torch.clamp(scales / (0.8 * k), min=1e-30))[
                :, None].expand(n, k, 3)

            engine.reset_densification_stats()
            profiling.tally("events.clone.added", clone_sel.sum())
            profiling.tally("events.split.added", split_sel.sum() * k)
            ret = ret.add_append(AppendSpec(clone_sel, duplicate_values(params, 1), 1))
            ret = ret.add_append(AppendSpec(split_sel, split_vals, k))
            return ret.merge_remove(split_sel)


def SplitCloneDensifierWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier],
        model, dataset,
        scene_extent: float = None,
        **configs):
    """SplitCloneDensifier over the densifier that
    ``base_densifier_constructor(model, dataset, **configs)`` builds; the
    scene extent is the dataset's (1.0 without one) unless given."""
    if scene_extent is None:
        scene_extent = dataset.scene_extent() if dataset is not None else 1.0
    keys = ("densify_from_iter", "densify_until_iter", "densify_interval",
            "densify_grad_threshold", "densify_percent_dense", "densify_n_split")
    own = {k: configs.pop(k) for k in keys if k in configs}
    return SplitCloneDensifier(base_densifier_constructor(model, dataset, **configs),
                               scene_extent, **own)
