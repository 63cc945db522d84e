"""The importance event's span and counters (utils/profiling.py), on a tiny
``densify-pruning-shculling`` run with the scale regulariser on the CPU,
whose importance prune fires after steps 2 and 4 and no other event does.

  * Under a profiler each ``r3dgs.event.densify`` holds one
    ``r3dgs.event.importance``, which holds the sweep's ``r3dgs.sweep_pass``.
  * ``events.importance`` counts the events, ``events.importance.removed``
    (under a profiler) the rows of their masks, ``sweep.views`` the views
    the passes swept.
  * With the profiler off the run makes the host syncs of the same run
    with no tally at all; under a profiler the tally is read in one
    ``event_counts`` sync an event.
  * With the profiler off no span is recorded, nothing is tallied, and the
    other counters still count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.importance import trainer as timp  # noqa: E402
from reduced_3dgs_torch.prepare import prepare_trainer  # noqa: E402
from reduced_3dgs_torch.utils import profiling  # noqa: E402

from .test_torch_event_tracing import parent, profiled  # noqa: E402
from .test_torch_fixtures import (random_cloud_np, torch_dataset, torch_model,  # noqa: E402
                                  views_np)

N = 100
HW = (32, 48)
VIEWS = 3
STEPS = 4
EVENTS = (2, 4)
# The importance prune at steps 2 and 4 over the three views; every other
# event kind stays off.
CONFIGS = dict(densify_from_iter=100, densify_until_iter=100, densify_interval=100,
               prune_from_iter=100, prune_until_iter=100, prune_interval=100,
               importance_prune_from_iter=2, importance_prune_until_iter=4,
               importance_prune_interval=2, cull_at_steps=[100],
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
    params, degrees = random_cloud_np(47, N, spread=0.7)
    cams = views_np(VIEWS, *HW)
    gt = torch_model(params, degrees)
    with torch.no_grad():
        images = [torch.clamp(gt.render(c)["render"], 0, 1).numpy()
                  for c in torch_dataset(cams)]
    rng = np.random.default_rng(48)
    start = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
    return dict(start=start, degrees=degrees, cams=cams, images=images)


def flagship(scene):
    model = torch_model(scene["start"], scene["degrees"])
    dataset = torch_dataset(scene["cams"], scene["images"])
    trainer, _ = prepare_trainer(model, dataset, "densify-pruning-shculling",
                                 with_scale_reg=True, configs=CONFIGS)
    return model, dataset, trainer


def run(model, dataset, trainer):
    for i in range(STEPS):
        trainer.step(dataset[i % len(dataset)])


def recording_masks(monkeypatch) -> list:
    """The importance masks of the run, as ``prune_gaussians`` returns them."""
    masks = []
    prune = timp.prune_gaussians

    def recording(*args, **kwargs):
        masks.append(prune(*args, **kwargs))
        return masks[-1]

    monkeypatch.setattr(timp, "prune_gaussians", recording)
    return masks


def test_the_importance_span_nests_in_the_event(scene):
    model, dataset, trainer = flagship(scene)
    events = profiled(lambda: run(model, dataset, trainer))
    densify = [e for e in events if e.name == "r3dgs.event.densify"]
    importance = [e for e in events if e.name == "r3dgs.event.importance"]
    assert len(densify) == len(importance) == len(EVENTS)
    for event in importance:
        assert parent(events, event).name == "r3dgs.event.densify"
        inside = [e.name for e in events if parent(events, e) is event]
        assert inside == ["r3dgs.sweep_pass"]
    passes = [e for e in events if e.name == "r3dgs.sweep_pass"]
    assert all(parent(events, e).name == "r3dgs.event.importance" for e in passes)


def test_the_counters_agree_with_the_masks_and_the_views(scene, monkeypatch):
    model, dataset, trainer = flagship(scene)
    masks = recording_masks(monkeypatch)
    profiled(lambda: run(model, dataset, trainer))
    out = profiling.counters()
    assert len(masks) == len(EVENTS)
    assert out["events.importance"] == len(EVENTS)
    assert out["events.importance.removed"] == sum(int(m.sum()) for m in masks) > 0
    assert out["events.densify.removed"] == out["events.importance.removed"]
    assert out["sweep.passes"] >= len(EVENTS)
    assert out["sweep.views"] == VIEWS * out["sweep.passes"]


def _host_syncs(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k.startswith("host_syncs")}


def test_the_tally_is_read_in_the_events_one_sync(scene, monkeypatch):
    """With the profiler off the run's host syncs, by site, are those of
    the same run with no tally held; under a profiler one ``event_counts``
    read an event holds the tally, and every other sync is unchanged."""
    model, dataset, trainer = flagship(scene)
    run(model, dataset, trainer)
    plain = _host_syncs(profiling.counters())
    profiling.reset_counters()
    model, dataset, trainer = flagship(scene)
    profiled(lambda: run(model, dataset, trainer))
    traced = _host_syncs(profiling.counters())
    profiling.reset_counters()
    monkeypatch.setattr(profiling, "tally", lambda name, n: None)
    model, dataset, trainer = flagship(scene)
    run(model, dataset, trainer)
    untallied = _host_syncs(profiling.counters())
    assert plain == untallied
    assert "host_syncs.event_counts" not in plain
    assert traced.pop("host_syncs.event_counts") == len(EVENTS)
    traced["host_syncs"] -= len(EVENTS)
    assert traced == untallied


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
    assert out["events.importance"] == len(EVENTS) and out["sweep.views"] > 0
    assert "events.importance.removed" not in out
    assert out["events.densify.removed"] > 0
