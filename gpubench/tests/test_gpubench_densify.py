"""The densify cell at a tiny size on the CPU, through ``run.execute``: 2,500
Gaussians of the configuration's scene (1,500 kept), 16 views of 32 x 48, a
segment of 20 steps whose events fire after its 10th and 20th steps.

  * A sound run is correct.
  * Each fault planted in the program makes it not correct: the mercy prune
    skipped, the split children's scales over 0.8 (not 1.6), the opacity
    prune at 0.05, the clones not appended.
  * Two restored segments give the same Gaussian count after each event and
    the same losses; set-up sizes the key buffer for every view.
  * The step time (``camera_step_ms``, the cell's) leaves out the
    restores' time.
  * The cell's configuration is the flagship's truck setting with the
    program's default schedule of events written out.
  * The reference of the events imports nothing of the program or of JAX,
    and the cell's readers give None on a record without the program's
    spans and counters (a parent without them), and divide by the events,
    captures and segments of the traced window.
"""
import math
from types import SimpleNamespace

import pytest
import torch

from conftest import SEED
from gpubench import run
from gpubench.drivers import densify
from test_gpubench_imports import FORBIDDEN, loaded_after

CELL = "truck-flagship.densify"
# Small splats, so that the tiny scene clones as well as splits; opacities
# from 0.02, so that a prune at 0.05 has rows to take; the screen-space
# gradients of 32 x 48 views are ~1e-3, so the threshold is raised.
TINY = {"config": {"n_gaussians": 2500, "image_height": 32, "image_width": 48,
                   "views": {"count": 16, "fovx_deg": 70.0, "radius": 5.2, "elevation": 0.25,
                             "elevation_wave": 0.2, "waves": 3},
                   "scene": {"sh_degree": 3, "splat_per_spacing": 0.5, "rest_sigma": 0.05,
                             "opacity_min": 0.02, "opacity_max": 0.95},
                   "options": {"densify_grad_threshold": 0.0002, "densify_interval": 10,
                               "prune_interval": 10}},
        "workload": {"segment": [7001, 7020], "trace_steps": 20}}


def tiny(trace=False, seconds=0.2, config=None):
    torch.set_num_threads(4)
    overrides = {"config": {**TINY["config"], **(config or {})}, "workload": TINY["workload"]}
    return run.execute(CELL, SEED, seconds, trace, "cpu", overrides=overrides)


def test_sound_tiny_run_is_correct():
    result = tiny()
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"camera_step_ms", "setup_s"}


def test_traced_tiny_run_reads_the_event_metrics():
    result = tiny(trace=True)
    assert result["correct"] is True, result["checks"]
    assert {"event_ms.densify", "knn_ms.densify", "redundancy_ms.densify",
            "key_resizes.densify"} <= set(result["metrics"])
    assert result["metrics"]["event_ms.densify"]["value"] > 0


def _no_mercy(monkeypatch):
    from reduced_3dgs_torch.pruning import trainer as tp
    monkeypatch.setattr(tp, "mercy_gaussians",
                        lambda model, *a, **k: torch.zeros(model.num_points, dtype=torch.bool))


def _split_scale(monkeypatch):
    from reduced_3dgs_torch.trainer.densifier import split_clone
    original = split_clone.SplitCloneDensifier.densify_and_prune

    def wide_children(self, *args, **kwargs):
        ret = original(self, *args, **kwargs)
        specs = tuple(sp._replace(values={**sp.values,
                                          "scaling": sp.values["scaling"] + math.log(2.0)})
                      if sp.copies > 1 else sp for sp in ret.appends)
        return ret._replace(appends=specs)

    monkeypatch.setattr(split_clone.SplitCloneDensifier, "densify_and_prune", wide_children)


def _no_clones(monkeypatch):
    from reduced_3dgs_torch.trainer.densifier import abc
    original = abc.DensificationTrainer.apply_instruction

    def without_clones(self, instruction):
        specs = tuple(sp._replace(select=torch.zeros_like(sp.select)) if sp.copies == 1
                      else sp for sp in instruction.appends)
        return original(self, instruction._replace(appends=specs))

    monkeypatch.setattr(abc.DensificationTrainer, "apply_instruction", without_clones)


@pytest.mark.parametrize("fault", ["no_mercy", "split_scale", "opacity_threshold",
                                   "no_clones"])
def test_planted_fault_fails(monkeypatch, fault):
    config = None
    if fault == "opacity_threshold":
        config = {"options": {**TINY["config"]["options"], "prune_opacity_threshold": 0.05}}
    else:
        {"no_mercy": _no_mercy, "split_scale": _split_scale,
         "no_clones": _no_clones}[fault](monkeypatch)
    result = tiny(config=config)
    assert result["correct"] is False, (fault, result["checks"])


def _tiny_ctx():
    wl, cfg = run.cell(CELL)
    return SimpleNamespace(config={**cfg, **TINY["config"]}, workload={**wl, **TINY["workload"]},
                           seed=SEED, seconds=0.1, trace=False, device=torch.device("cpu"),
                           t_start=0.0)


def test_restored_segments_repeat():
    torch.set_num_threads(4)
    st = densify.setup(_tiny_ctx())
    outcomes = []
    for _ in range(2):
        densify.restore(st.trainer, st.loop, st.saved, torch.device("cpu"))
        losses0 = len(st.loop.losses)
        events = densify.run_events(st.trainer, st.loop, st.order, st.event_steps)
        st.loop.run(st.steps - (st.trainer.curr_step - st.saved["step"]))
        outcomes.append(([e["program"]["after"]["params"]["xyz"].shape[0] for e in events],
                         torch.stack(st.loop.losses[losses0:])))
    assert st.trainer.curr_step == st.saved["step"] + st.steps
    assert outcomes[0][0] == outcomes[1][0]
    assert torch.equal(outcomes[0][1], outcomes[1][1])


def test_key_buffer_holds_every_view_of_the_start_model():
    """Set-up sizes the key buffer, so that no view of the start model
    overflows it: the compared steps render every entry."""
    torch.set_num_threads(4)
    st = densify.setup(_tiny_ctx())
    engine, dataset = st.trainer.engine, st.loop.dataset
    with torch.no_grad():
        most = max(int(engine.model.render(dataset[i])["num_rendered"])
                   for i in range(len(dataset)))
    assert engine.key_buffer_for(dataset[0]) >= int(1.15 * most)
    assert st.saved["key"]["_key_buffer_size"] == engine._key_buffer_size


def test_step_time_leaves_out_the_restores(monkeypatch):
    """A clock that jumps 1,000 s at every restore: the timed segments do
    not see the jumps."""
    offset = [0.0]
    real = densify.time.perf_counter
    restore = densify.restore

    def jumping_restore(*args, **kwargs):
        offset[0] += 1000.0
        return restore(*args, **kwargs)

    monkeypatch.setattr(densify, "time", SimpleNamespace(perf_counter=lambda: real() + offset[0]))
    monkeypatch.setattr(densify, "restore", jumping_restore)
    result = tiny()
    steps = TINY["workload"]["segment"][1] - TINY["workload"]["segment"][0] + 1
    assert result["attempted"] == steps
    assert result["metrics"]["camera_step_ms"]["value"] * steps < 1000.0 * 1e3 / 10


def _defaults(fn, keys=None):
    import inspect
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty and (keys is None or k in keys)}


def test_the_cell_configuration_is_the_truck_setting_with_its_schedule():
    """The cell's configuration is the flagship's truck setting, its scene,
    views, learning rates and loss alike; its options write out the
    schedule the program runs by default, with the setting's gradient
    threshold, so that the events fire where a truck run fires them."""
    import json
    from reduced_3dgs_torch.pruning.trainer import PruningDensifierWrapper
    from reduced_3dgs_torch.trainer.densifier.split_clone import SplitCloneDensifier
    from reduced_3dgs_torch.trainer.extensions import OpacityResetTrainerWrapper
    wl, cfg = run.cell(CELL)
    flagship = json.loads((run.HERE / "configs" / "truck-flagship.json").read_text())
    own = {"name", "source", "phase", "options", "start_sh_shares", "assumed"}
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in flagship.items() if k not in own}
    expected = {**_defaults(SplitCloneDensifier.__init__), **_defaults(PruningDensifierWrapper),
                **_defaults(OpacityResetTrainerWrapper, ("opacity_reset_interval",))}
    expected.pop("densify_n_split")
    expected.pop("seed")
    expected["densify_grad_threshold"] = flagship["options"]["densify_grad_threshold"]
    assert cfg["options"] == expected
    assert wl["config"] == cfg["name"] != flagship["name"]


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after("import gpubench.reference.densify")
    assert not loaded & set(FORBIDDEN + ["reduced_3dgs_torch"])


@pytest.mark.parametrize("metric", ["event_ms", "knn_ms", "redundancy_ms", "capture_ms",
                                    "key_resizes"])
def test_readers_return_none_without_the_program_records(metric):
    record = {"units": 200, "program_spans": {}, "program_counters": {}}
    assert run.metric_reader(f"{metric}.densify")(record) is None
    assert run.metric_reader(f"{metric}.densify")({"units": 200}) is None


def test_readers_divide_by_events_and_captures():
    record = {"units": 200,
              "program_spans": {"event.densify": {"count": 2, "host_s": 0.8, "device_s": 0.7},
                                "knn": {"count": 2, "host_s": 0.2, "device_s": 0.3},
                                "redundancy": {"count": 2, "host_s": 0.2, "device_s": 0.1}},
              "program_counters": {"graph.captures": 3, "graph.capture_ms": 600.0,
                                   "key_buffer.regrows": 2, "key_buffer.shrinks": 1},
              "segments": 1.0}
    read = {m: run.metric_reader(f"{m}.densify")(record)
            for m in ("event_ms", "knn_ms", "redundancy_ms", "capture_ms", "key_resizes")}
    assert read == pytest.approx({"event_ms": 400.0, "knn_ms": 150.0, "redundancy_ms": 50.0,
                                  "capture_ms": 200.0, "key_resizes": 3.0})


def _side(mercy_rows, n):
    mask = torch.zeros(n, dtype=torch.bool)
    mask[list(mercy_rows)] = True
    empty = torch.zeros(n, dtype=torch.bool)
    return {"clone": empty, "split": empty, "removed": mask.clone(), "mercy": mask,
            "near_densify": empty,
            "n": n - len(mercy_rows), "consistent": True, "clones": {}, "children": {},
            "new_m": {}, "new_v": {}, "draw": None}


def test_the_mercy_cliff_takes_the_side_nearer_the_program():
    """Where the reference's mean + std lies near a whole number, the rows
    at it may fall either way: the numbers take the nearer side, and a
    program far from both still fails."""
    n = 100
    reference = _side(range(10), n)
    reference["alternative"] = {k: v for k, v in _side(range(40), n).items()
                                if k in ("mercy", "removed", "n")}
    near_other = densify.event_numbers(_side(range(40), n), reference)
    assert near_other["mercy_mask_gap"] == 0.0 and near_other["event_count_gap"] == 0.0
    assert "alternative" in reference
    skipped = densify.event_numbers(_side((), n), reference)
    assert skipped["mercy_mask_gap"] == 1.0


def test_densify_flips_within_round_off_of_a_threshold_do_not_count():
    """A row decided differently counts, unless the reference finds its
    densify decision within round-off of a threshold."""
    n = 100
    reference = _side((), n)
    reference["clone"] = torch.arange(n) < 10
    reference["near_densify"] = torch.arange(n) == 10
    program = {**reference, "clone": torch.arange(n) <= 10, "consistent": False}
    assert densify.event_numbers(program, reference)["densify_mask_gap"] == 0.0
    program["clone"] = (torch.arange(n) <= 10) | (torch.arange(n) == 20)
    assert densify.event_numbers(program, reference)["densify_mask_gap"] == 0.1


def test_the_reference_mercy_gives_both_sides_only_near_a_whole_number():
    from gpubench.reference import densify as ref
    metric = torch.tensor([5.0] * 50 + [6.0] * 50, dtype=torch.float64)
    opacity = torch.linspace(0.1, 0.9, 100, dtype=torch.float64)
    assert ref._merciful(metric, opacity, 5.5).sum() == 25
    assert ref._merciful(metric, opacity, 4.5).sum() == 50


def test_draw_z_pools_the_events():
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(400, 3, generator=g), torch.randn(300, 3, generator=g)]
    assert densify.draw_z(draws) < 4.0
    assert densify.draw_z([2.0 * d for d in draws]) > 20.0
    assert densify.draw_z([None]) == 0.0
