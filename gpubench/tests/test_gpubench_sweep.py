"""The sweep cell at a tiny size on the CPU, through ``run.execute``: 2,500
Gaussians of the configuration's scene, 16 views of 32 x 48, a segment of
20 steps whose importance prune fires after its last step, compared over
every 4th view.

  * A sound run is correct.
  * Each fault planted in the program's path makes it not correct: the
    sweep's first view left out of the sums, the percentile at 0.2, the
    T_alpha_avg mask left out of the OR, v_pow at 0; the control's and the
    faults' readings, put in the program's place, fail too, a fault that
    moves rows only inside the other masks' union by its own mask.
  * The sampled sums are the event's own pass: a pass that renders its
    first half of the views twice fails ``count_gap``.
  * The state after the event is the held state's kept rows: an apply
    that keeps the rows shifted by one, or gathers Adam's moments shifted
    by one, fails ``importance_apply_gap``.
  * A traced run's record carries the work of its steps' views, which the
    B1 and B3 readers read.
  * Two restored segments give the same Gaussian count after the event and
    the same losses.
  * The step time (``camera_step_ms``) leaves out the restores' time.
  * The cell's configuration is the flagship's truck setting with the
    program's importance schedule written out.
  * The reference imports nothing of the program or of JAX, and the cell's
    new readers give None on a record without the program's spans and
    counters (a parent without them) and divide by views and launches.
"""
import json
from types import SimpleNamespace

import pytest
import torch

from conftest import SEED
from gpubench import run
from gpubench.drivers import densify, sweep
from test_gpubench_imports import FORBIDDEN, loaded_after

CELL = "truck-flagship.sweep"
# Splats of one point spacing, so that every Gaussian is seen somewhere
# (at four spacings a third of a 2,500-point scene hides behind the rest
# in every view, and every rule then prunes those same rows); thresholds
# far above every score, so that each of the four masks is its type's
# lowest tenth and a fault in any of them moves rows.
OPTIONS = {"importance_prune_thr_v_important_score": 1e9, "importance_prune_thr_count": 1e9,
           "importance_prune_thr_T_alpha": 1e9, "importance_prune_thr_T_alpha_avg": 1e9}
TINY = {"config": {"n_gaussians": 2500, "image_height": 32, "image_width": 48,
                   "views": {"count": 16, "fovx_deg": 70.0, "radius": 5.2, "elevation": 0.25,
                             "elevation_wave": 0.2, "waves": 3},
                   "scene": {"sh_degree": 3, "splat_per_spacing": 1.0, "rest_sigma": 0.05,
                             "opacity_min": 0.6, "opacity_max": 0.95}},
        "workload": {"start_step": 16980, "segment": [16981, 17000], "trace_steps": 20,
                     "compare_every": 4}}
# prune_gaussians' positional arguments that the rule faults change.
PERCENT, THR_T_ALPHA_AVG, V_POW = 4, 10, 11


def _config():
    _, cfg = run.cell(CELL)
    return {**TINY["config"], "options": {**cfg["options"], **OPTIONS}}


def tiny(trace=False, seconds=0.2):
    torch.set_num_threads(4)
    overrides = {"config": _config(), "workload": TINY["workload"]}
    return run.execute(CELL, SEED, seconds, trace, "cpu", overrides=overrides)


def test_sound_tiny_run_is_correct():
    result = tiny()
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"camera_step_ms", "setup_s"}
    assert {"count_gap", "score_gap", "importance_mask_gap", "event_count_gap",
            "importance_apply_gap", "loss_gap", "grad_gap", "last_grad_gap",
            "change_gap"} <= set(result["checks"])
    assert result["checks"]["importance_apply_gap"]["value"] == 0.0


def test_traced_tiny_run_reads_the_event_metrics():
    result = tiny(trace=True)
    assert result["correct"] is True, result["checks"]
    assert "event_ms.sweep" in result["metrics"]
    assert result["metrics"]["event_ms.sweep"]["value"] > 0


def _argument_fault(monkeypatch, position, value):
    from reduced_3dgs_torch.importance import trainer as importance
    original = importance.prune_gaussians

    def faulty(*args, **kwargs):
        args = list(args)
        args[position] = value
        return original(*args, **kwargs)

    monkeypatch.setattr(importance, "prune_gaussians", faulty)


def _no_first_view(monkeypatch):
    from reduced_3dgs_torch.importance import trainer as importance
    original = importance.static_sweep
    monkeypatch.setattr(importance, "static_sweep",
                        lambda model, cameras, *a, **k: original(model, cameras[1:], *a, **k))


def _repeated_views(monkeypatch):
    from reduced_3dgs_torch.importance import trainer as importance
    original = importance.static_sweep

    def repeated(model, cameras, *a, **k):
        half = list(cameras[:len(cameras) // 2])
        return original(model, half + half, *a, **k)

    monkeypatch.setattr(importance, "static_sweep", repeated)


def _shifted_keep(monkeypatch, groups):
    """An apply whose kept rows of ``groups`` are the next row's."""
    from reduced_3dgs_torch.trainer.densifier import abc
    original = abc.keep_rows

    def shifted(trees, keep):
        out = original(trees, keep)
        moved = original(trees, torch.roll(keep, 1))
        return {g: (moved[g] if g in groups else t) for g, t in out.items()}

    monkeypatch.setattr(abc, "keep_rows", shifted)


@pytest.mark.parametrize("fault", ["no_first_view", "percent", "no_t_alpha_avg", "no_v_pow",
                                   "repeated_views", "shifted_rows", "shifted_moments"])
def test_planted_fault_fails(monkeypatch, fault):
    failing = None
    if fault == "no_first_view":
        _no_first_view(monkeypatch)
    elif fault == "repeated_views":
        _repeated_views(monkeypatch)
        failing = "count_gap"
    elif fault.startswith("shifted"):
        groups = {"shifted_rows": ("params", "adam_m", "adam_v", "aux", "accum"),
                  "shifted_moments": ("adam_m", "adam_v")}[fault]
        _shifted_keep(monkeypatch, groups)
        failing = "importance_apply_gap"
    else:
        position, value = {"percent": (PERCENT, 0.2), "no_t_alpha_avg": (THR_T_ALPHA_AVG, None),
                           "no_v_pow": (V_POW, 0.0)}[fault]
        _argument_fault(monkeypatch, position, value)
    result = tiny()
    assert result["correct"] is False, (fault, result["checks"])
    if failing is not None:
        check = result["checks"][failing]
        assert not check["value"] <= check["limit"], (fault, result["checks"])


def test_the_control_and_every_fault_fail_in_the_program_place():
    from gpubench import sweep_control
    wl, cfg = run.cell(CELL)
    torch.set_num_threads(4)
    out = sweep_control.readings({**cfg, **_config()}, {**wl, **TINY["workload"]}, SEED, 0.1,
                                 torch.device("cpu"))
    assert out["correct"] is True
    assert set(out["variants"]) == set(sweep_control.VARIANTS)
    failing = {v for v, n in out["variants"].items() if n["fails"]}
    assert failing == set(sweep_control.VARIANTS), out["variants"]


def _tiny_ctx():
    wl, cfg = run.cell(CELL)
    return SimpleNamespace(config={**cfg, **_config()}, workload={**wl, **TINY["workload"]},
                           seed=SEED, seconds=0.1, trace=False, device=torch.device("cpu"),
                           t_start=0.0)


def test_traced_record_carries_the_steps_work():
    """The traced segment's record holds the reference's work of every
    ``work_every``-th traced step's view, from which the B1 and B3 readers
    give a share once the card's kernels are in the record."""
    torch.set_num_threads(4)
    ctx = _tiny_ctx()
    ctx.trace = True
    record = sweep.run(ctx)["record"]
    steps = TINY["workload"]["trace_steps"]
    every = ctx.workload["work_every"]
    assert len(record["work"]) == -(-steps // every)
    assert all(w["entries"] > 0 and w["gaussians"] > 0 for w in record["work"])
    record = {**record, "kernels": {"void composite_fwd_kernel<false>(...)": 1e-3,
                                    "composite_bwd_kernel(...)": 1e-3}}
    for metric in ("b1_roofline.sweep", "b3_roofline.sweep"):
        assert 0 < run.metric_reader(metric)(record) < 100


def test_restored_segments_repeat():
    torch.set_num_threads(4)
    st = densify.setup(_tiny_ctx())
    (event,) = st.event_steps
    outcomes = []
    for _ in range(2):
        densify.restore(st.trainer, st.loop, st.saved, torch.device("cpu"))
        losses0 = len(st.loop.losses)
        seen = sweep.run_event(st.trainer, st.loop, event, 4)
        outcomes.append((seen["n"], seen["mask"], torch.stack(st.loop.losses[losses0:])))
    assert st.trainer.curr_step == st.saved["step"] + st.steps
    assert outcomes[0][0] == outcomes[1][0] < st.saved["trees"]["params"]["xyz"].shape[0]
    assert torch.equal(outcomes[0][1], outcomes[1][1])
    assert torch.equal(outcomes[0][2], outcomes[1][2])


def test_step_time_leaves_out_the_restores(monkeypatch):
    """A clock that jumps 1,000 s at every restore: the timed segments do
    not see the jumps."""
    offset = [0.0]
    real = sweep.time.perf_counter
    restore = densify.restore

    def jumping_restore(*args, **kwargs):
        offset[0] += 1000.0
        return restore(*args, **kwargs)

    monkeypatch.setattr(sweep, "time", SimpleNamespace(perf_counter=lambda: real() + offset[0]))
    monkeypatch.setattr(densify, "restore", jumping_restore)
    result = tiny()
    steps = TINY["workload"]["segment"][1] - TINY["workload"]["segment"][0] + 1
    assert result["attempted"] == steps
    assert result["metrics"]["camera_step_ms"]["value"] * steps < 1000.0 * 1e3 / 10


def _defaults(fn):
    import inspect
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_the_cell_configuration_is_the_truck_setting_with_its_schedule():
    """The cell's configuration is the flagship's truck setting, its scene,
    views, learning rates and loss alike; its options write out the
    importance prune's schedule and thresholds as the program holds them by
    default, beside the setting's own gradient threshold; the reference's
    rules read the same."""
    from gpubench.reference import importance as ref
    from reduced_3dgs_torch.importance.trainer import ImportancePruner
    wl, cfg = run.cell(CELL)
    flagship = json.loads((run.HERE / "configs" / "truck-flagship.json").read_text())
    own = {"name", "source", "phase", "options", "assumed"}
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in flagship.items() if k not in own}
    assert cfg["options"] == {**_defaults(ImportancePruner.__init__), **flagship["options"]}
    assert ref.rules(cfg["options"]) == ref.rules({})
    assert wl["config"] == cfg["name"] != flagship["name"]
    assert wl["start_sh_shares"] == flagship["start_sh_shares"] and wl["keep_share"] == 1.0


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after("import gpubench.reference.importance")
    assert not loaded & set(FORBIDDEN + ["reduced_3dgs_torch"])


def test_a_fault_inside_the_other_masks_fails_its_own_mask():
    """v_pow at 0 may move rows only inside what the other masks prune (at
    the cell's size it decided no row of the OR differently on one seed in
    twelve): its OR, row count and state after the event are then the sound
    ones, and its own mask still fails ``importance_mask_gap``."""
    from gpubench.reference import importance as ref_importance
    wl, cfg = run.cell(CELL)
    rules = ref_importance.rules(cfg["options"])
    gen = torch.Generator().manual_seed(SEED)
    n, hidden = 1000, 500

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, generator=gen)

    # The first half is unseen by count, T_alpha and T_alpha_avg, so their
    # masks (each score at or under its tenth, 0, with ties) prune it whole;
    # v_important_score's lowest tenth falls inside it, ordered by volume.
    sums = {"count": torch.cat([torch.zeros(hidden), torch.randint(5, 50, (n - hidden,),
                                                                   generator=gen).float()]),
            "opacity": torch.cat([uniform(0.01, 0.02, hidden), uniform(10, 20, n - hidden)]),
            "t_alpha": torch.cat([torch.zeros(hidden), uniform(1, 2, n - hidden)])}
    scaling = torch.randn(n, 3, generator=gen)
    kinds = ref_importance.type_masks(*sums.values(), scaling, **rules)
    mask = ref_importance.union(kinds, sums["count"])[0]
    held = {"params": {"scaling": scaling, "xyz": torch.randn(n, 3, generator=gen)}}
    sound = {"sums": sums, "sampled": sums, "params": held["params"], "held": held,
             "masks": [m for m, _ in kinds.values()], "mask": mask, "n_before": n,
             "n": n - int(mask.sum()),
             "after": {g: {k: v[~mask] for k, v in t.items()} for g, t in held.items()}}
    reference = {**sums, "first": {k: torch.zeros(n) for k in sums}}
    event_limits = {k: v for k, v in wl["limits"].items()
                    if k in ("count_gap", "score_gap", "importance_mask_gap",
                             "event_count_gap", "importance_apply_gap")}

    numbers = sweep.event_numbers(sound, reference, rules, torch.device("cpu"))
    assert all(numbers[k] == 0 for k in event_limits), numbers
    fault = sweep.variant_side("no_v_pow", sound, reference, None, rules, torch.device("cpu"))
    assert torch.equal(fault["mask"], mask)
    assert not torch.equal(fault["masks"][0], sound["masks"][0])
    numbers = sweep.event_numbers(fault, reference, rules, torch.device("cpu"))
    assert numbers["event_count_gap"] == numbers["importance_apply_gap"] == 0
    assert numbers["importance_mask_gap"] > 10 * event_limits["importance_mask_gap"], numbers


@pytest.mark.parametrize("metric", ["sweep_view_ms", "b2_roofline"])
def test_readers_return_none_without_the_program_records(metric):
    work = [{"entries": 10, "scanned_pairs": 100, "contributing_pairs": 50, "tiles": 2,
             "pixels": 400}]
    record = {"units": 100, "kernels": {"composite_fwd_kernel<true>(...)": 0.5},
              "program_spans": {}, "program_counters": {}, "sweep_work": work}
    assert run.metric_reader(f"{metric}.sweep")(record) is None
    assert run.metric_reader(f"{metric}.sweep")({"units": 100, "kernels": {}}) is None


def test_readers_divide_by_views_and_launches():
    from gpubench import counts
    work = [{"entries": 10, "scanned_pairs": 100, "contributing_pairs": 50, "tiles": 2,
             "pixels": 400}] * 2
    record = {"units": 100, "kernels": {"void composite_fwd_kernel<true>(...)": 0.5,
                                        "void composite_fwd_kernel<false>(...)": 9.0},
              "program_spans": {"sweep_pass": {"count": 1, "host_s": 2.0, "device_s": 1.0},
                                "event.densify": {"count": 1, "host_s": 2.5, "device_s": 1.2}},
              "program_counters": {"sweep.views": 250,
                                   "composite.composite_fwd_stats.launches": 250},
              "sweep_work": work}
    assert run.metric_reader("sweep_view_ms.sweep")(record) == pytest.approx(4.0)
    assert run.metric_reader("event_ms.sweep")(record) == pytest.approx(2500.0)
    ops = 100 * counts.OPS_SCANNED + 50 * 4
    nbytes = 10 * (counts.B1_BYTES_ENTRY + 16) + 2 * counts.B1_BYTES_TILE \
        + 2 * 256 * counts.B1_BYTES_PIXEL
    assert run.metric_reader("b2_roofline.sweep")(record) == pytest.approx(
        counts.roofline_share(ops, nbytes, 0.5 / 250))
