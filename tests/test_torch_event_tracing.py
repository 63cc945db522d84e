"""The densify event's spans and counters (utils/profiling.py), on a tiny
``densify-pruning-shculling`` run with the scale regulariser on the CPU.

  * Under a profiler each ``r3dgs.event.densify`` holds ``r3dgs.event.
    split_clone``, ``.prune``, ``.mercy`` and ``.apply`` once each, and the
    mercy span holds ``r3dgs.knn`` and ``r3dgs.redundancy`` once each.
  * The counters agree with the masks the event used: ``events.clone.added``
    and ``events.split.added`` with the split's selections (their sum is
    ``events.densify.added``), ``events.prune.removed`` and
    ``events.mercy.removed`` with the two removal masks, ``knn.points``
    with the rows the search saw; the tallies are read in one sync an event.
  * With the profiler off no span is recorded, and the counters still count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.prepare import prepare_trainer  # noqa: E402
from reduced_3dgs_torch.pruning import trainer as tp  # noqa: E402
from reduced_3dgs_torch.trainer.densifier import opacity_pruner  # noqa: E402
from reduced_3dgs_torch.utils import profiling  # noqa: E402

from .test_torch_fixtures import (random_cloud_np, torch_dataset, torch_model,  # noqa: E402
                                  views_np)

N = 100
HW = (32, 48)
STEPS = 4
EVENTS = (2, 4)
# Events at steps 2 and 4; every other event kind stays off. The toy scene's
# screen-space gradients are ~1e-2, so the threshold is raised, and its
# scales are ~0.8 of the three views' extent, so the clone limit is raised
# to clone some and split others; box 3 gives the mercy prune a non-empty
# mask, and the opacity threshold 0.3 an opacity prune.
CONFIGS = dict(densify_from_iter=2, densify_until_iter=4, densify_interval=2,
               densify_grad_threshold=0.02, densify_percent_dense=0.8,
               prune_from_iter=2, prune_until_iter=4, prune_interval=2,
               prune_opacity_threshold=0.3, box_size=3.0,
               importance_prune_from_iter=100, importance_prune_until_iter=100,
               importance_prune_interval=100, cull_at_steps=[100],
               opacity_reset_interval=100, opacity_reset_until_iter=100,
               sh_degree_up_interval=1)


@pytest.fixture(autouse=True)
def fresh_counters(monkeypatch):
    monkeypatch.setenv("R3DGS_WINDOW", "1")
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(43, N, spread=0.7)
    cams = views_np(3, *HW)
    gt = torch_model(params, degrees)
    with torch.no_grad():
        images = [torch.clamp(gt.render(c)["render"], 0, 1).numpy()
                  for c in torch_dataset(cams)]
    rng = np.random.default_rng(44)
    start = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
    return dict(start=start, degrees=degrees, cams=cams, images=images)


def flagship(scene):
    model = torch_model(scene["start"], scene["degrees"])
    dataset = torch_dataset(scene["cams"], scene["images"])
    trainer, _ = prepare_trainer(model, dataset, "densify-pruning-shculling",
                                 with_scale_reg=True, configs=CONFIGS)
    return model, dataset, trainer


def densification_trainer(trainer):
    t = trainer
    while not hasattr(t, "apply_instruction"):
        t = t.base_trainer
    return t


def run(model, dataset, trainer):
    for i in range(STEPS):
        trainer.step(dataset[i % len(dataset)])


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("r3dgs.")]


def parent(events, e):
    """The innermost r3dgs.* event of ``e``'s thread that holds ``e``."""
    holders = [h for h in events if h is not e and h.thread == e.thread
               and h.time_range.start <= e.time_range.start
               and e.time_range.end <= h.time_range.end]
    return min(holders, key=lambda h: h.time_range.end - h.time_range.start, default=None)


def test_event_spans_nest_once_each_per_event(scene):
    model, dataset, trainer = flagship(scene)
    events = profiled(lambda: run(model, dataset, trainer))
    densify = [e for e in events if e.name == "r3dgs.event.densify"]
    assert len(densify) == len(EVENTS)
    for event in densify:
        inside = sorted(e.name for e in events if parent(events, e) is event)
        assert inside == ["r3dgs.event.apply", "r3dgs.event.mercy", "r3dgs.event.prune",
                          "r3dgs.event.split_clone"]
        (mercy,) = [e for e in events if e.name == "r3dgs.event.mercy"
                    and parent(events, e) is event]
        assert sorted(e.name for e in events if parent(events, e) is mercy) == [
            "r3dgs.knn", "r3dgs.redundancy"]
    for name in ("r3dgs.event.split_clone", "r3dgs.event.prune", "r3dgs.event.mercy",
                 "r3dgs.event.apply", "r3dgs.knn", "r3dgs.redundancy"):
        assert [e.name for e in events].count(name) == len(EVENTS), name


def test_event_counters_agree_with_the_masks(scene, monkeypatch):
    model, dataset, trainer = flagship(scene)
    dt = densification_trainer(trainer)
    seen = {"clone": 0, "split": 0, "prune": 0, "mercy": 0, "rows": 0, "added": 0}
    apply = dt.apply_instruction

    def recording_apply(instruction):
        if instruction.appends:
            clone, split = instruction.appends
            seen["clone"] += int(clone.select.sum()) * clone.copies
            seen["split"] += int(split.select.sum()) * split.copies
            seen["rows"] += model.num_points
        return apply(instruction)

    mercy, prune = tp.mercy_gaussians, opacity_pruner.OpacityPruner.prune

    def recording_mercy(*args, **kwargs):
        mask = mercy(*args, **kwargs)
        seen["mercy"] += int(mask.sum())
        return mask

    def recording_prune(self):
        mask = prune(self)
        seen["prune"] += int(mask.sum())
        return mask

    monkeypatch.setattr(dt, "apply_instruction", recording_apply)
    monkeypatch.setattr(tp, "mercy_gaussians", recording_mercy)
    monkeypatch.setattr(opacity_pruner.OpacityPruner, "prune", recording_prune)
    run(model, dataset, trainer)
    out = profiling.counters()
    assert out["events.densify"] == len(EVENTS)
    assert seen["clone"] > 0 and seen["split"] > 0 and seen["mercy"] > 0
    assert out["events.clone.added"] == seen["clone"]
    assert out["events.split.added"] == seen["split"]
    assert out["events.densify.added"] == out["events.clone.added"] + out["events.split.added"]
    assert out["events.prune.removed"] == seen["prune"]
    assert out["events.mercy.removed"] == seen["mercy"]
    assert out["knn.points"] == seen["rows"]
    assert out["host_syncs.event_counts"] == len(EVENTS)


def test_no_span_without_a_profiler(scene, monkeypatch):
    model, dataset, trainer = flagship(scene)
    regions = []
    record_function = torch.profiler.record_function

    def recorded(name, args=None):
        regions.append(name)
        return record_function(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    run(model, dataset, trainer)
    assert regions == []
    out = profiling.counters()
    assert out["events.densify"] == len(EVENTS) and out["knn.points"] > 0
    assert "events.mercy.removed" in out and "events.prune.removed" in out
