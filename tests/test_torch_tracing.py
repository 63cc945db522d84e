"""The port's spans and counters (utils/profiling.py) at the sites that use
them, on the CPU.

  * Outside a profiler a span is the one shared no-op context and records
    nothing; a sync still counts.
  * Under a profiler, a step holds r3dgs.step > forward > render >
    {preprocess, bin_and_sort, composite}, then backward, optimizer and
    hooks; a window holds r3dgs.window, its step and k in the region's
    argument string.
  * The host syncs: one entry count a render without a key buffer, two a
    viewer frame (the entry count and the frame's copy).
  * The key buffer's drains, overflows and regrowths; a densify event's
    rows; a static sweep's passes and regrowths; the SH cull as an event
    around its sweep; the counters line at the end of ``train.training``.
  * On the card (marker ``cuda``), a capture counts itself and sizes its
    graph's pool only while a profiler records.
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch import train as ttrain  # noqa: E402
from reduced_3dgs_torch import viewer as tviewer  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import launches as tlaunches  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import sweep as tsweep  # noqa: E402
from reduced_3dgs_torch.shculling import SHCullingTrainerWrapper  # noqa: E402
from reduced_3dgs_torch.trainer import BaseTrainer, Trainer  # noqa: E402
from reduced_3dgs_torch.trainer import base as tbase  # noqa: E402
from reduced_3dgs_torch.trainer.densifier.abc import (AppendSpec,  # noqa: E402
                                                      DensificationInstruction,
                                                      DensificationTrainer, NoopDensifier)
from reduced_3dgs_torch.utils import profiling  # noqa: E402

from .test_torch_fixtures import (random_cloud_np, torch_dataset, torch_model,  # noqa: E402
                                  views_np)

N = 60
HW = (32, 48)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(scope="module")
def scene():
    params, degrees = random_cloud_np(41, N, spread=0.7)
    cams = views_np(3, *HW)
    gt = torch_model(params, degrees)
    with torch.no_grad():
        images = [torch.clamp(gt.render(c)["render"], 0, 1).numpy()
                  for c in torch_dataset(cams)]
    rng = np.random.default_rng(42)
    start = {k: (v + 0.02 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
    return dict(start=start, degrees=degrees, cams=cams, images=images)


def model_and_dataset(scene):
    return (torch_model(scene["start"], scene["degrees"]),
            torch_dataset(scene["cams"], scene["images"]))


def profiled(fn):
    """(fn(), the r3dgs.* host events recorded around it)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("r3dgs.")]


def parent(events, e):
    """The innermost r3dgs.* event of ``e``'s thread that holds ``e``."""
    holders = [h for h in events if h is not e and h.thread == e.thread
               and h.time_range.start <= e.time_range.start
               and e.time_range.end <= h.time_range.end]
    return min(holders, key=lambda h: h.time_range.end - h.time_range.start,
               default=None)


def children(events, name):
    return [e.name for e in events if (p := parent(events, e)) is not None
            and p.name == name]


def test_span_outside_a_profiler_is_the_shared_noop():
    assert profiling.span("step", step=1) is profiling.NO_SPAN
    assert profiling.annotate("region") is profiling.NO_SPAN
    assert not profiling.recording()
    with profiling.sync("site") as entered:
        assert entered is None
    assert profiling.counters()["host_syncs.site"] == 1
    assert profiling.sync("site", 0) is profiling.NO_SPAN
    assert profiling.counters()["host_syncs"] == 1
    _, events = profiled(lambda: torch.ones(4).sum())
    assert events == []


def test_counters_copy_and_launch_tallies():
    profiling.count("a")
    profiling.count("a", 2.5)
    out = profiling.counters()
    assert out["a"] == 3.5
    assert {"composite.composite_fwd.launches", "composite.composite_fwd_stats.launches",
            "composite.composite_bwd.launches"} <= set(out)
    out["a"] = 0
    assert profiling.counters()["a"] == 3.5
    profiling.reset_counters()
    assert "a" not in profiling.counters()


def test_a_step_nests_its_phases(scene):
    model, dataset = model_and_dataset(scene)
    trainer = BaseTrainer(model, dataset)
    trainer.step(dataset[0])
    _, events = profiled(lambda: trainer.step(dataset[1]))
    names = [e.name for e in events]
    assert names.count("r3dgs.step") == 1
    assert sorted(children(events, "r3dgs.step")) == sorted(
        ["r3dgs.forward", "r3dgs.backward", "r3dgs.optimizer", "r3dgs.hooks"])
    assert "r3dgs.render" in children(events, "r3dgs.forward")
    assert sorted(children(events, "r3dgs.render")) == sorted(
        ["r3dgs.preprocess", "r3dgs.bin_and_sort", "r3dgs.composite"])
    assert "r3dgs.preprocess" in children(events, "r3dgs.forward")
    assert not any(n.startswith("r3dgs.sync.") for n in names)


def test_a_window_holds_its_steps_and_args(scene, monkeypatch):
    model, dataset = model_and_dataset(scene)
    trainer = BaseTrainer(model, dataset)
    trainer.step(dataset[0])
    regions = []
    record_function = torch.profiler.record_function

    def recorded(name, args=None):
        regions.append((name, args))
        return record_function(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    _, events = profiled(lambda: trainer.step_many([dataset[i] for i in range(3)]))
    assert ("r3dgs.window", "step=2, k=3") in regions
    assert [e.name for e in events].count("r3dgs.window") == 1
    assert [e.name for e in events].count("r3dgs.forward") == 3
    assert children(events, "r3dgs.window").count("r3dgs.hooks") == 1


def test_render_without_key_buffer_counts_one_sync(scene):
    model, dataset = model_and_dataset(scene)
    with torch.no_grad():
        model.render(dataset[0])
    assert profiling.counters()["host_syncs.entry_count"] == 1
    with torch.no_grad():
        model.render(dataset[0], key_buffer_size=4096)
    assert profiling.counters()["host_syncs"] == 1


def test_viewer_frame_counts_two_syncs(scene):
    model, _ = model_and_dataset(scene)
    app = tviewer.ViewerApp(model, *HW)
    _, events = profiled(lambda: app.render_frame(0.3, -0.1))
    out = profiling.counters()
    assert out["host_syncs"] == 2
    assert out["host_syncs.entry_count"] == out["host_syncs.frame_copy"] == 1
    names = [e.name for e in events]
    assert {"r3dgs.frame", "r3dgs.encode", "r3dgs.sync.frame_copy",
            "r3dgs.sync.entry_count"} <= set(names)
    assert "r3dgs.sync.frame_copy" in children(events, "r3dgs.frame")


def test_tiny_key_buffer_counts_overflows_and_regrows(scene, monkeypatch):
    monkeypatch.setattr(tbase, "KEY_BUFFER_DRAIN", 2)
    model, dataset = model_and_dataset(scene)
    trainer = BaseTrainer(model, dataset)
    trainer.set_key_buffer(dataset[0], 64)
    trainer.step(dataset[0])
    trainer.step(dataset[1])
    out = profiling.counters()
    assert out["key_buffer.drains"] == 1 and out["key_buffer.overflows"] == 2
    assert out["key_buffer.regrows"] == 1 and out["host_syncs.overflow_drain"] == 1
    assert trainer.key_buffer_for(dataset[0]) == 128


def test_apply_instruction_counts_a_densify_event(scene):
    model, dataset = model_and_dataset(scene)
    trainer = DensificationTrainer(BaseTrainer(model, dataset), NoopDensifier(model))
    remove = torch.zeros(N, dtype=torch.bool)
    remove[[1, 5, 9]] = True
    select = torch.zeros(N, dtype=torch.bool)
    select[[0, 2]] = True
    values = {k: torch.stack([p.detach()] * 2, dim=1) for k, p in model.param_dict().items()}
    trainer.apply_instruction(DensificationInstruction(
        remove_mask=remove, appends=(AppendSpec(select, values, 2),)))
    out = profiling.counters()
    assert model.num_points == N - 3 + 4
    assert out["events.densify"] == 1
    assert out["events.densify.removed"] == 3 and out["events.densify.added"] == 4
    assert out["host_syncs.event_rows"] == len(values) + sum(
        len(t) for t in trainer.engine.state_trees().values())
    trainer.apply_instruction(DensificationInstruction())
    assert profiling.counters()["events.densify"] == 1


def test_static_sweep_overflow_counts_passes_and_regrows():
    model = SimpleNamespace(num_points=100, _xyz=torch.zeros(100, 3))
    cameras = [SimpleNamespace(image_width=64, image_height=64)] * 3
    regrown = []

    def make_body(K, acc):
        def body(model, camera):
            acc["views"] += 1
            return torch.tensor(K < 200)
        return body

    acc = tsweep.static_sweep(model, cameras, make_body, lambda: {"views": 0},
                              key_buffer=128, on_regrow=regrown.append)
    out = profiling.counters()
    assert acc["views"] == 3 and regrown == [256]
    assert out["sweep.passes"] == 2 and out["sweep.regrows"] == 1
    assert out["key_buffer.regrows"] == 1 and out["host_syncs.sweep_overflow"] == 2


def test_sh_cull_is_an_event_around_its_sweep(scene, monkeypatch):
    monkeypatch.setenv("R3DGS_WINDOW", "1")
    model, dataset = model_and_dataset(scene)
    trainer = SHCullingTrainerWrapper(Trainer, model, dataset, cull_at_steps=[2],
                                      sh_degree_up_interval=1)

    def run():
        for i in range(3):
            trainer.step(dataset[i])

    _, events = profiled(run)
    assert profiling.counters()["events.sh_cull"] == 1
    assert [e.name for e in events].count("r3dgs.event.sh_cull") == 1
    assert "r3dgs.sweep_pass" in children(events, "r3dgs.event.sh_cull")
    assert "r3dgs.event.sh_cull" in children(events, "r3dgs.hooks")


def test_training_prints_the_counters(scene, tmp_path, capsys):
    model, dataset = model_and_dataset(scene)
    trainer = BaseTrainer(model, dataset)
    ttrain.training(dataset, model, trainer, None, str(tmp_path), iteration=8,
                    save_iterations=[], device="cpu", log_interval=4,
                    generator=random.Random(1))
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Counters: ")]
    fields = dict(f.split("=") for f in line[len("Counters: "):].split())
    assert float(fields["host_syncs.log"]) == 2 and float(fields["host_syncs.psnr"]) == 2
    assert "composite.composite_fwd.launches" in fields


@pytest.mark.cuda
def test_capture_sizes_its_pool_only_under_a_profiler():
    """A capture counts itself and its wall ms, and walks the allocator's
    snapshot for its pool's size only while a profiler records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a graph is captured there")
    x = torch.ones(1 << 20, device="cuda")

    def body():
        return x * 2.0

    graph, _, out, _, capture_s, pool = tlaunches.capture_graph(body, body, x.device)
    graph.replay()
    assert pool is None and float(out[0]) == 2.0
    counted = profiling.counters()
    assert counted["graph.captures"] == 1
    assert counted["graph.capture_ms"] == pytest.approx(capture_s * 1e3)
    (_, _, _, _, _, pool), events = profiled(lambda: tlaunches.capture_graph(body, body, x.device))
    assert pool >= x.numel() * 4
    assert [e.name for e in events].count("r3dgs.capture") == 1
