"""Training traffic through the importance-pruning phase: segments of steps,
each replayed from one restored state, whose last step is followed by the
importance prune (a sweep over every training view with statistics, the
scores, the mask and its application), as in training.

Set-up is the densify cell's (``drivers/densify.py`` ``setup``): the scene
and the views' images on the card, the start model (a ``keep_share`` of the
configuration's perturbed Gaussians at the SH degrees of
``start_sh_shares``), the mode's trainer (``prepare.prepare_trainer``) at
``start_step`` with Adam's moments at zero, the key buffer sized for the
start model's views, and the held state. The trainer is driven through
``train.training``'s window loop (``Loop`` of ``gpubench/drivers/train.py``)
over one view order drawn from the seed. The first ``compare_steps`` steps
are compared with the reference as in the training cells; the rest of that
segment warms up, the event and its captures included.

Each segment runs steps ``segment[0]`` to ``segment[1]`` after a restore
outside the timed time (``densify.restore``), so every segment does the same
work: the step graph's capture in its first window (the restored state's
tensors are new, and the engine keeps one graph), its steps, and the event
after its last step. The measured window replays whole segments until
``--seconds`` have passed; ``camera_step_ms`` is the segments' summed wall
time, each synchronised at its end, over their steps. A traced run restores
once more and traces ``trace_steps`` steps through
``gpubench.program_trace.traced``.

After the window, one more restored segment decides ``correct`` for the
event (``run_event``): the program runs up to the event step and the event,
and the driver records, by wrapping the program's ``prune_list`` and
``score2mask``, the sweep's three sums over every view, the mask, the state
the sweep rendered and the state after the event; and, by tapping the same
pass (its accumulators, its per-view body and the sweep graph's replays,
``SweepTap``), what every ``compare_every``-th view of it added to the
sums. The reference (``reference/importance.py``) sums the same views from
the same state, and applies its rules to the program's sums over every view
(``event_numbers``). With ``variants`` the same records give the control's
and the faults' readings (``bf16`` and ``reference.importance.FAULTS``),
each in the program's place. A traced run's record gets the reference's
work of those views (``sweep_work``), which ``metrics/b2_roofline.py``
reads, and of every ``work_every``-th traced step's view at the state the
sweep rendered (``work``: N holds over the traced steps, the event coming
after the last), which ``metrics/b1_roofline.py`` and ``b3_roofline.py``
read.

Workload keys: ``start_step``, ``keep_share``, ``start_sh_shares``,
``segment`` ([first, last] step; first is ``start_step`` + 1, and the event
falls after last), ``window``, ``compare_steps``, ``compare_every``,
``trace_steps``, ``work_every`` and ``variants`` (absent in a cell).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import correctness, program, program_trace
from gpubench.drivers import densify
from gpubench.drivers.train import compare, hold_grads
from gpubench.reference import importance as ref_importance
from gpubench.reference import render as ref_render
from gpubench.reference import train as ref_train

SUMS = ("count", "opacity", "t_alpha")
# The counters the window's log line gives a segment.
LOGGED_COUNTERS = ("graph.", "key_buffer.", "events.", "sweep.", "host_syncs")


class SweepTap:
    """The sweep pass's own contributions of every ``every``-th view,
    summed on the device: each such view's difference of the pass's
    accumulators across it, the first view's from zero (a pass starts from
    zeroed sums). It follows the program's views in the order they are
    rendered: the body's eager calls (on the card the first view, on the
    CPU every view) and the sweep graph's replays. A new set of
    accumulators (a pass after a regrow) starts it over."""

    def __init__(self, every: int):
        self.every, self.acc, self.sums, self.views = every, None, None, 0

    def start(self, acc: dict):
        self.acc, self.sums, self.views = acc, None, 0

    def view(self, render):
        """Run ``render()``, one view's work on the accumulators."""
        sampled = self.views % self.every == 0
        before = ({k: torch.zeros_like(v) for k, v in self.acc.items()} if self.views == 0
                  else {k: v.clone() for k, v in self.acc.items()}) if sampled else None
        out = render()
        if sampled:
            diff = {k: (self.acc[k] - before[k]).double() for k in SUMS}
            self.sums = diff if self.sums is None else {k: self.sums[k] + diff[k] for k in SUMS}
        self.views += 1
        return out

    def host(self):
        """The sums on the host; None where no view was tapped."""
        return None if self.sums is None else {k: v.to("cpu", copy=True)
                                               for k, v in self.sums.items()}


def _sums(tensors) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in zip(SUMS, tensors)}


def run_event(trainer, loop, step: int, every: int) -> dict:
    """Run on from the restored state through ``step`` and the importance
    event after it, recording the sweep's sums over every view (``sums``),
    the same pass's contributions of every ``every``-th view (``sampled``,
    ``SweepTap``) and the views it rendered (``views``), the state the
    sweep rendered (``held``, every group of the engine's state trees;
    ``params`` and ``degrees`` of it), the rows before (``n_before``) and
    after (``n``) the event, the state after the event (``after``), the
    masks ``score2mask`` gave, in order (``masks``), and the importance
    mask (``mask``, their OR; None where it gave none). All on the host."""
    from reduced_3dgs_torch.importance import trainer as importance
    from reduced_3dgs_torch.ops.rasterize import sweep as sweep_mod
    engine = trainer.engine
    loop.run(step - 1 - trainer.curr_step)
    seen, masks, tap = {}, [], SweepTap(every)
    prune_list, score2mask = importance.prune_list, importance.score2mask
    accumulators, counts_body = importance.count_accumulators, importance.counts_body
    replay = sweep_mod.SweepGraph.replay

    def recording_prune_list(gaussians, *args, **kwargs):
        held = densify.host_trees(engine.state_trees())
        sums = prune_list(gaussians, *args, **kwargs)
        seen.update(sums=_sums(sums), sampled=tap.host(), views=tap.views, held=held,
                    params=held["params"], degrees=held["aux"]["degrees"],
                    n_before=gaussians.num_points)
        return sums

    def recording_score2mask(*args, **kwargs):
        mask = score2mask(*args, **kwargs)
        masks.append(mask.cpu())
        return mask

    def tapped_accumulators(*args, **kwargs):
        acc = accumulators(*args, **kwargs)
        tap.start(acc)
        return acc

    def tapped_body(key_buffer_size, acc):
        body = counts_body(key_buffer_size, acc)

        def tapped(model, camera):
            if model._xyz.is_cuda and torch.cuda.is_current_stream_capturing():
                return body(model, camera)
            return tap.view(lambda: body(model, camera))
        return tapped

    def tapped_replay(graph, camera):
        return tap.view(lambda: replay(graph, camera))

    importance.prune_list, importance.score2mask = recording_prune_list, recording_score2mask
    importance.count_accumulators, importance.counts_body = tapped_accumulators, tapped_body
    sweep_mod.SweepGraph.replay = tapped_replay
    try:
        loop.run(1)
    finally:
        importance.prune_list, importance.score2mask = prune_list, score2mask
        importance.count_accumulators, importance.counts_body = accumulators, counts_body
        sweep_mod.SweepGraph.replay = replay
    if "sums" not in seen:
        raise RuntimeError(f"no importance sweep after step {step}")
    seen["mask"], seen["masks"] = None, masks
    for mask in masks:
        seen["mask"] = mask if seen["mask"] is None else seen["mask"] | mask
    seen["n"] = trainer.model.num_points
    seen["after"] = densify.host_trees(engine.state_trees())
    return seen


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    return float((p.double() - r.double()).norm() / max(float(r.double().norm()), 1e-30))


def apply_gap(held: dict, after: dict, keep: torch.Tensor) -> float:
    """The worst relative norm gap, over every tensor of the state trees,
    of the state after the event against the held state's rows ``keep``;
    infinite where a tensor's shape differs."""
    worst = 0.0
    for group, tree in held.items():
        for k, v in tree.items():
            kept = v[keep]
            if after[group][k].shape != kept.shape:
                return float("inf")
            worst = max(worst, _gap(after[group][k], kept))
    return worst


def event_numbers(p: dict, reference: dict, rules: dict, device) -> dict:
    """The event's numbers: the program's outcome ``p`` (``run_event``'s
    record, or a variant's in its form) against the reference's sums
    (``reference.importance.sweep``) over the same views, and the rules'
    keywords (``reference.importance.rules``).

    ``count_gap`` is sum |count_p - count_r| over sum count_r (a pixel's
    gate or latch may flip on the last bit); ``score_gap`` the larger
    relative norm gap of the two float sums; both infinite where the pass
    tapped no view. ``importance_mask_gap`` holds the program's masks to
    the reference's rules on the program's own sums over every view: the
    worst, over their OR and over each type's mask (so that a fault in a
    mask whose rows the others prune too still shows), of the rows decided
    differently, outside the rows within round-off of a threshold, over the
    rows the rules remove; infinite where the program made another number
    of masks. ``event_count_gap`` is |N - N_ref| / N_ref after the event,
    N_ref the rows before less those the rules remove.
    ``importance_apply_gap`` is ``apply_gap`` of the
    program's state after the event against the held state's rows that the
    rules keep, the program's decision taken at the rows within round-off
    of a threshold."""
    c_r = reference["count"].double().cpu()
    if p["sampled"] is None:
        out = {"count_gap": float("inf"), "score_gap": float("inf")}
    else:
        c_p = p["sampled"]["count"].double()
        out = {"count_gap": float((c_p - c_r).abs().sum()) / max(float(c_r.sum()), 1.0),
               "score_gap": max(_gap(p["sampled"][k], reference[k].cpu())
                                for k in ("opacity", "t_alpha"))}
    sums = [p["sums"][k].to(device) for k in SUMS]
    kinds = ref_importance.type_masks(*sums, p["params"]["scaling"].to(device), **rules)
    kinds = {k: (m.cpu(), close.cpu()) for k, (m, close) in kinds.items()}
    mask, near = ref_importance.union(kinds, sums[0].cpu())
    removed = int(mask.sum())
    if (p["mask"] is None or p["mask"].shape != mask.shape
            or len(p["masks"]) != len(kinds)):
        out["importance_mask_gap"] = out["importance_apply_gap"] = float("inf")
    else:
        pairs = [(p["mask"], mask, near)] + [
            (pm, m, close) for pm, (m, close) in zip(p["masks"], kinds.values())]
        out["importance_mask_gap"] = max(int(((pm ^ m) & ~close).sum()) / max(int(m.sum()), 1)
                                         for pm, m, close in pairs)
        out["importance_apply_gap"] = apply_gap(p["held"], p["after"],
                                                ~torch.where(near, p["mask"], mask))
    n_ref = p["n_before"] - removed
    out["event_count_gap"] = abs(p["n"] - n_ref) / max(n_ref, 1)
    out["removed"] = removed
    return out


def variant_side(variant: str, p: dict, reference: dict, low: dict, rules: dict,
                 device) -> dict:
    """A variant's outcome in ``run_event``'s form, from the program's own
    sums over every view and the reference's sums over the compared views:
    the control ``bf16`` (the reference's sums in bfloat16, its rules in
    bfloat16 on the program's sums; ``low`` is its sweep) or a fault of
    ``reference.importance.FAULTS`` (on the sound ``rules``). Its state
    after the event is the held state's rows its mask keeps."""
    side = {**p, "sampled": {k: reference[k].cpu() for k in SUMS}}
    sums = {k: p["sums"][k].to(device) for k in SUMS}
    rules = ref_importance.faulty_rules(variant, rules)
    if variant == "bf16":
        side["sampled"] = {k: low[k].cpu() for k in SUMS}
        rules = {**rules, "dtype": torch.bfloat16}
    elif variant == "no_first_view":
        first = {k: v.cpu() for k, v in reference["first"].items()}
        side["sampled"] = {k: side["sampled"][k] - first[k] for k in SUMS}
        sums = {k: sums[k] - reference["first"][k].to(sums[k].dtype) for k in SUMS}
        side["sums"] = {k: v.cpu() for k, v in sums.items()}
    kinds = ref_importance.type_masks(*(sums[k] for k in SUMS),
                                      p["params"]["scaling"].to(device), **rules)
    side["masks"] = [m.cpu() for m, _ in kinds.values()]
    side["mask"] = ref_importance.union(kinds, sums["count"])[0].cpu()
    side["n"] = p["n_before"] - int(side["mask"].sum())
    side["after"] = {g: {k: v[~side["mask"]] for k, v in t.items()}
                     for g, t in p["held"].items()}
    return side


def run(ctx) -> dict:
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    st = densify.setup(ctx)
    if st.event_steps != [wl["segment"][1]]:
        raise ValueError(f"the segment's one event falls after its last step, not after "
                         f"{st.event_steps}")
    trainer, loop, steps = st.trainer, st.loop, st.steps
    engine, model = trainer.engine, trainer.model

    loop.run(1)
    first_m = program.host(engine.adam.m)
    held, remove = hold_grads(model.param_dict())
    loop.run(wl["compare_steps"] - 1)
    remove()
    last_grads = program.host(held)
    del held
    compared = list(loop.views)
    after = program.host(model.param_dict())
    after["densify_accum"] = engine.xyz_grad_accum.detach().to("cpu", copy=True)
    compared_losses = [float(x) for x in loop.losses[:wl["compare_steps"]]]
    program.log(ctx, "compared steps done")
    loop.run(steps - wl["compare_steps"])
    program.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start
    program.log(ctx, f"set-up done: the warm-up segment ended at {model.num_points} Gaussians")

    losses0, times = len(loop.losses), []
    before = program_trace.counter_snapshot()
    t_window = time.perf_counter()
    while not times or time.perf_counter() - t_window < ctx.seconds:
        densify.restore(trainer, loop, st.saved, dev)
        program.synchronize(dev)
        t0 = time.perf_counter()
        loop.run(steps)
        program.synchronize(dev)
        times.append(time.perf_counter() - t0)
    segments, timed = len(times), sum(times)
    window_losses = torch.stack(loop.losses[losses0:])
    failed = int((~torch.isfinite(window_losses)).sum()) + loop.nonfinite
    counted = program_trace.counter_delta(before, program_trace.counter_snapshot()) or {}
    program.log(ctx, f"window: {segments} segments of {steps} steps in {timed:.3f} s timed "
                     f"(a segment {min(times):.4f}-{max(times):.4f} s, median "
                     f"{sorted(times)[segments // 2]:.4f}), {model.num_points} Gaussians at the "
                     f"end; counters a segment: " + ", ".join(
                         f"{k} {v / segments:g}" for k, v in counted.items()
                         if k.startswith(LOGGED_COUNTERS)))

    record = None
    if ctx.trace:
        densify.restore(trainer, loop, st.saved, dev)
        t_views = len(loop.views)
        record = program_trace.traced(lambda: loop.run(wl["trace_steps"]), dev)
        traced_views = loop.views[t_views:]
        record.update(units=wl["trace_steps"], unit_s=timed / (segments * steps),
                      segments=wl["trace_steps"] / steps)
        program.log(ctx, "traced segment reduced")

    densify.restore(trainer, loop, st.saved, dev)
    seen = run_event(trainer, loop, st.event_steps[0], wl["compare_every"])
    program.log(ctx, f"event held: {seen['n_before']} -> {seen['n']} Gaussians, "
                     f"{seen['views']} views swept")
    peak = program.memory_peak(dev)
    poses, fov, init, degrees = st.poses, st.fov, st.init, st.degrees
    del st, trainer, engine, model, loop
    program.release(dev)

    with correctness.full_float32():
        views = [program.view_args(poses[i], cfg, fov) for i in compared]
        gts = program.reference_ground_truth(cfg, seed, dev, views)
        start = {k: v.to(dev) for k, v in init.items()}
        extent = ref_train.scene_extent(np.stack([-rot.T @ t for rot, t in poses]))
        ref = ref_train.train(start, degrees, views, gts, cfg, extent, wl["start_step"])
        numbers = compare(compared_losses, first_m, last_grads, after, init, ref, None, compared)
        numbers["failed_steps"] = failed
        del ref, start, gts
        program.release(dev)
        program.log(ctx, f"reference compared: {numbers}")

        sampled = [ref_render.make_view(rot, t, cfg["image_height"], cfg["image_width"],
                                        fov[0], fov[1], device=dev)
                   for rot, t in poses[::wl["compare_every"]]]
        params = {k: v.to(dev) for k, v in seen["params"].items()}
        state_degrees = seen["degrees"].to(dev)
        t_ref = time.perf_counter()
        sound = ref_importance.sweep(params, state_degrees, sampled)
        program.synchronize(dev)
        ref_s = time.perf_counter() - t_ref
        rules = ref_importance.rules(cfg["options"])
        event = event_numbers(seen, sound, rules, dev)
        numbers.update(event, reference_s_per_view=ref_s / len(sampled))
        program.log(ctx, f"event compared over {len(sampled)} views "
                         f"({ref_s / len(sampled):.3f} s a view in the reference): {event}")
        variants = wl.get("variants", [])
        if variants:
            low = (ref_importance.sweep(params, state_degrees, sampled, torch.bfloat16)
                   if "bf16" in variants else None)
            numbers["variants"] = {
                v: event_numbers(variant_side(v, seen, sound, low, rules, dev), sound, rules,
                                 dev)
                for v in variants}
        if ctx.trace:
            record["sweep_work"] = sound["work"]
            record["work"] = [program.view_work(params, state_degrees,
                                                program.view_args(poses[i], cfg, fov), dev)
                              for i in traced_views[::wl["work_every"]]]
            program.log(ctx, "work counted")
    return {"metrics": {"camera_step_ms": timed / (segments * steps) * 1e3,
                        "setup_s": setup_s},
            "numbers": numbers, "attempted": segments * steps, "failed": failed,
            "memory_peak_bytes": peak, "record": record}
