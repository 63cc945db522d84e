"""Rendered-importance pruning (counterpart of
reduced_3dgs_tpu/importance/trainer.py:29-320).

Every camera is rendered with statistics (the statistics compositor, a CUDA
kernel on the card), and each Gaussian is scored by what it contributed:
the pixels it blends into (count), count x opacity, and the sum of its
blend weights alpha T. The scores are summed over the cameras and the
lowest are pruned. All scoring policies and defaults are the JAX
package's (and the reference's): important_score, v_important_score,
max_v_important_score, count, T_alpha, T_alpha_avg and comprehensive.

The sweep (``prune_list``) takes three forms:

  * more than one view of one image size and FoV, for the 3DGS family
    (``ops.rasterize.sweep.sweeps_statically``): ``sweep_counts``, the
    counterpart of JAX's ``_sweep_counts`` (importance/trainer.py:88-140).
    Every view renders through the static key buffer with no host sync; on
    the card the per-view body is a CUDA graph replayed once per view
    (``ops.rasterize.sweep.static_sweep``). The overflow flags are ORed on
    the device and read once per pass; after an overflow K doubles, up to
    N x tiles, and the pass runs again. K starts from the training engine's
    buffer for the image size when the pruner passes its engine, and a
    regrown K is written back there, where the step reads it (JAX's model
    and sweep share ``_key_buffer_size``); otherwise from
    ``default_key_buffer_size`` of N's capacity tier;
  * other views: ``exact_counts``, one eager render per view at its exact
    entry count (JAX's loop, :73-85, which JAX takes only for views of
    mixed sizes), and so for the 2DGS family at any views
    (``static_sweeps`` False: its plain compositor pays for every slot of a
    static buffer);
  * on a device mesh (``parallel.ShardedTrainer``): per batch over the mesh
    (``parallel.stats.sharded_prune_list``), as JAX's per-batch programs
    are; gloo collectives cannot be captured.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..dataset import camera as camera_mod
from ..dataset.camera import Camera
from ..ops.rasterize.sweep import static_sweep, sweeps_statically
from ..trainer import (AbstractDensifier, DensificationTrainer, DensifierWrapper,
                       NoopDensifier)
from ..utils import profiling


def count_render(model, camera: Camera) -> dict:
    """Render with the importance statistics."""
    out = model.forward(camera, with_stats=True)
    return {
        "render": out["render"],
        "visibility_filter": out["radii"] > 0,
        "radii": out["radii"],
        "gaussians_count": out["gaussians_count"],
        "opacity_important_score": out["opacity_important_score"],
        "T_alpha_important_score": out["T_alpha_important_score"],
    }


def count_accumulators(n: int, device) -> dict:
    """The sweep's zeroed sums: count int32, opacity and T_alpha scores."""
    return {"count": torch.zeros((n,), dtype=torch.int32, device=device),
            "opacity": torch.zeros((n,), dtype=torch.float32, device=device),
            "t_alpha": torch.zeros((n,), dtype=torch.float32, device=device)}


def _add_counts(acc: dict, out: dict):
    acc["count"] += out["gaussians_count"]
    acc["opacity"] += out["opacity_important_score"]
    acc["t_alpha"] += out["T_alpha_important_score"]


def counts_body(key_buffer_size: int, acc: dict):
    """The sweep's per-view body: ``body(model, camera)`` renders with
    statistics through a static buffer of ``key_buffer_size`` entries, adds
    into ``acc`` in place and returns the 0-d overflow flag."""
    def body(model, camera):
        out = model.render(camera, with_stats=True, key_buffer_size=key_buffer_size)
        _add_counts(acc, out)
        return out["overflow"]
    return body


def sweep_counts(model, cameras, key_buffer=None, on_regrow=None):
    """(count, opacity score, T_alpha score) summed over ``cameras``
    (``sweeps_statically``) through the static key buffer, starting at
    ``key_buffer`` and regrown on overflow (``static_sweep``)."""
    acc = static_sweep(model, cameras, counts_body,
                       lambda: count_accumulators(model.num_points, model._xyz.device),
                       key_buffer, on_regrow)
    return acc["count"], acc["opacity"], acc["t_alpha"]


@torch.no_grad()
def exact_counts(model, cameras):
    """The same sums from one eager render per camera at its exact entry
    count."""
    acc = count_accumulators(model.num_points, model._xyz.device)
    for camera in cameras:
        _add_counts(acc, count_render(model, camera))
    return acc["count"], acc["opacity"], acc["t_alpha"]


def prune_list(model, dataset, resize: Optional[int] = None, mesh=None, *, engine=None):
    """(count int32, opacity score, T_alpha score), each [N], summed over
    every camera of ``dataset``. With ``resize``, each camera is rendered at
    its aspect ratio with ``resize`` pixels along its longer side. With
    ``mesh`` (a ``parallel.Mesh``), the sweep runs sharded over it.
    ``engine``, the training engine, sizes the key buffer of a static sweep
    and takes its regrowth."""
    if mesh is not None:
        from ..parallel.stats import sharded_prune_list
        return sharded_prune_list(model, dataset, mesh, resize)
    cams = camera_mod.sweep_cameras(dataset, resize, model._xyz.device)
    if sweeps_statically(model, cams):
        return sweep_counts(model, cams, **({} if engine is None
                                            else engine.sweep_buffer(cams[0])))
    return exact_counts(model, cams)


def calculate_v_imp_score(gaussians, imp_list: torch.Tensor, v_pow: float) -> torch.Tensor:
    """Volume-adaptive importance: ``imp_list`` times
    (volume / 90th-percentile-largest volume) ** v_pow."""
    n = imp_list.shape[0]
    with torch.no_grad():
        volume = torch.prod(gaussians.get_scaling[:n], dim=1)
    sorted_volume = torch.sort(volume, descending=True).values
    kth_percent_largest = sorted_volume[min(int(n * 0.9), n - 1)]
    return torch.pow(volume / kth_percent_largest, v_pow) * imp_list


def score2mask(percent: float, import_score: torch.Tensor, threshold=None) -> torch.Tensor:
    """Prune every score at or below min(threshold, the ``percent``
    percentile of the scores)."""
    score = import_score.to(torch.float32)
    value_nth_percentile = torch.sort(score).values[int(percent * (score.shape[0] - 1))]
    thr = (value_nth_percentile if threshold is None
           else torch.clamp(value_nth_percentile, max=threshold))
    return score <= thr


def prune_gaussians(gaussians, dataset, resize: Optional[int] = None,
                    prune_type: str = "comprehensive", prune_percent: float = 0.1,
                    prune_thr_important_score=None, prune_thr_v_important_score=None,
                    prune_thr_max_v_important_score=None, prune_thr_count=None,
                    prune_thr_T_alpha=None, prune_thr_T_alpha_avg=None,
                    v_pow: float = 0.1, mesh=None, engine=None) -> torch.Tensor:
    """The [N] bool removal mask of importance type ``prune_type``; raises
    ValueError for an unknown type. ``comprehensive`` ORs the masks of every
    type whose threshold is given. ``mesh`` shards the sweep; ``engine``
    sizes a static sweep's key buffer (``prune_list``)."""
    gaussian_list, opacity_imp_list, t_alpha_imp_list = (
        prune_list(gaussians, dataset, resize, engine=engine) if mesh is None
        else prune_list(gaussians, dataset, resize, mesh=mesh))
    glist = gaussian_list.to(torch.float32)

    def t_alpha_avg():
        return torch.where(glist > 0, t_alpha_imp_list / torch.clamp(glist, min=1),
                           torch.zeros_like(glist))

    def max_v_list():
        with torch.no_grad():
            scaling = gaussians.get_scaling[:glist.shape[0]]
        return opacity_imp_list * torch.max(scaling, dim=1).values

    scores = {
        "important_score": (lambda: opacity_imp_list, prune_thr_important_score),
        "v_important_score": (lambda: calculate_v_imp_score(gaussians, opacity_imp_list, v_pow),
                              prune_thr_v_important_score),
        "max_v_important_score": (max_v_list, prune_thr_max_v_important_score),
        "count": (lambda: glist, prune_thr_count),
        "T_alpha": (lambda: t_alpha_imp_list, prune_thr_T_alpha),
        "T_alpha_avg": (t_alpha_avg, prune_thr_T_alpha_avg),
    }
    if prune_type in scores:
        score, threshold = scores[prune_type]
        return score2mask(prune_percent, score(), threshold)
    if prune_type == "comprehensive":
        mask = torch.zeros(glist.shape, dtype=torch.bool, device=glist.device)
        for score, threshold in scores.values():
            if threshold is not None:
                mask |= score2mask(prune_percent, score(), threshold)
        return mask
    raise ValueError(f"Unsupported pruning method {prune_type!r}")


class ImportancePruner(DensifierWrapper):
    """Runs importance pruning at every step in [from_iter, until_iter] that
    is a multiple of ``importance_prune_interval`` (defaults 15000..20000
    every 1000)."""

    def __init__(
            self, base_densifier: AbstractDensifier, dataset,
            importance_prune_from_iter: int = 15000,
            importance_prune_until_iter: int = 20000,
            importance_prune_interval: int = 1000,
            importance_score_resize: Optional[int] = None,
            importance_prune_type: str = "comprehensive",
            importance_prune_percent: float = 0.1,
            importance_prune_thr_important_score=None,
            importance_prune_thr_v_important_score: float = 3.0,
            importance_prune_thr_max_v_important_score=None,
            importance_prune_thr_count: float = 1,
            importance_prune_thr_T_alpha: float = 1,
            importance_prune_thr_T_alpha_avg: float = 0.001,
            importance_v_pow: float = 0.1):
        super().__init__(base_densifier)
        self.dataset = dataset
        self.importance_prune_from_iter = importance_prune_from_iter
        self.importance_prune_until_iter = importance_prune_until_iter
        self.importance_prune_interval = importance_prune_interval
        self.resize = importance_score_resize
        self.prune_type = importance_prune_type
        self.prune_percent = importance_prune_percent
        self.prune_thr_important_score = importance_prune_thr_important_score
        self.prune_thr_v_important_score = importance_prune_thr_v_important_score
        self.prune_thr_max_v_important_score = importance_prune_thr_max_v_important_score
        self.prune_thr_count = importance_prune_thr_count
        self.prune_thr_T_alpha = importance_prune_thr_T_alpha
        self.prune_thr_T_alpha_avg = importance_prune_thr_T_alpha_avg
        self.v_pow = importance_v_pow

    def fires(self, step: int) -> bool:
        return (self.importance_prune_from_iter <= step <= self.importance_prune_until_iter
                and step % self.importance_prune_interval == 0)


    def fires_at(self, step: int) -> bool:
        return self.fires(step) or super().fires_at(step)

    def densify_and_prune(self, loss, out, camera, step: int):
        """The chain's instruction with this event's removal mask ORed in
        where it fires: the sweep, the scores and the mask in the span
        ``r3dgs.event.importance``, counted under ``events.importance`` and,
        while a profiler records, tallied under ``events.importance.removed``:
        an importance event alone holds no other tally, so the read would
        be a host sync of its own."""
        ret = super().densify_and_prune(loss, out, camera, step)
        if self.fires(step):
            # A sharded engine sweeps over its own mesh; the engine's key
            # buffer sizes a static sweep.
            engine = self.trainer.engine
            with profiling.span("event.importance", step=step):
                remove_mask = prune_gaussians(
                    self.trainer.model, self.dataset, self.resize, self.prune_type,
                    self.prune_percent, self.prune_thr_important_score,
                    self.prune_thr_v_important_score, self.prune_thr_max_v_important_score,
                    self.prune_thr_count, self.prune_thr_T_alpha, self.prune_thr_T_alpha_avg,
                    self.v_pow, mesh=getattr(engine, "mesh", None), engine=engine)
                profiling.count("events.importance")
                if profiling.recording():
                    profiling.tally("events.importance.removed", remove_mask.sum())
            ret = ret.merge_remove(remove_mask)
        return ret


_OWN_KEYS = ("importance_prune_from_iter", "importance_prune_until_iter",
             "importance_prune_interval", "importance_score_resize",
             "importance_prune_type", "importance_prune_percent",
             "importance_prune_thr_important_score",
             "importance_prune_thr_v_important_score",
             "importance_prune_thr_max_v_important_score",
             "importance_prune_thr_count", "importance_prune_thr_T_alpha",
             "importance_prune_thr_T_alpha_avg", "importance_v_pow")


def ImportancePruningDensifierWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier], model, dataset,
        **configs):
    own = {k: configs.pop(k) for k in _OWN_KEYS if k in configs}
    return ImportancePruner(base_densifier_constructor(model, dataset, **configs), dataset,
                            **own)


def ImportancePruningTrainerWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier], model, dataset,
        **configs):
    return DensificationTrainer.from_densifier_constructor(
        partial(ImportancePruningDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def BaseImportancePruningTrainer(model, dataset, **configs):
    """Trainer + importance pruning:
    DensificationTrainer(Trainer, ImportancePruner(NoopDensifier))."""
    return ImportancePruningTrainerWrapper(
        lambda model, dataset, **cfg: NoopDensifier(model), model, dataset, **configs)
