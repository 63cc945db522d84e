"""Training traffic through the densification phase: segments of steps,
each replayed from one restored state, whose events (split and clone, the
opacity prune and the mercy prune) fire at the end of the windows that
``fires_at`` cuts, as in training.

Set-up builds the scene and the views' images on the card, the start model
and the mode's trainer (``prepare.prepare_trainer``) at ``start_step``, as a
resumed checkpoint would: a random ``keep_share`` of the configuration's
perturbed Gaussians (drawn from the seed), at the SH degrees of
``start_sh_shares``, Adam's moments at zero with its count at the start
step, the densification sums at zero, the key buffer sized for the start
model's views (``size_key_buffer``). It holds that state on the card and
drives the trainer through ``train.training``'s window loop (``Loop`` of
``gpubench/drivers/train.py``) over one view order drawn from the seed, the
same in every segment. The first ``compare_steps`` steps are compared with the
reference as in the training cells; the rest of that segment warms up.

Each segment runs steps ``segment[0]`` to ``segment[1]`` after a restore
outside the timed time: the held state trees (clones, through
``set_state_trees``), the trainer's step and Adam's count, the key buffer's
bookkeeping, the loop's step and epoch position and the card's generator.
So every segment does the same work, the captures after its start and after
each event included. The measured window replays whole segments until
``--seconds`` have passed; the step time, reported as ``camera_step_ms``
(whose bound the cell's spread needs), is the summed wall time of the
segments, each synchronised at its end, over their steps. A traced run
restores once more and traces ``trace_steps`` steps through
``gpubench.program_trace.traced``.

After the window, one more restored segment decides ``correct`` for the
events: before each event step the state after the step before is held,
and the step and its event run through the program; the reference
(``reference.densify.event``) takes the same step from the held state on
the same view and applies the event by its rules. ``event_numbers`` holds
the two outcomes to each other. With ``variants`` the same held states give
the control's and the faults' readings (``reference.densify.FAULTS`` and
``bf16``), each in the program's place.

Workload keys: ``start_step``, ``keep_share``, ``start_sh_shares``,
``segment`` ([first, last] step; first is ``start_step`` + 1), ``window``
(``R3DGS_WINDOW`` of the loop), ``compare_steps``, ``trace_steps`` and
``variants`` (absent in a cell).
"""
from __future__ import annotations

import copy
import gc
import itertools
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpubench import correctness, program, program_trace, scene
from gpubench.drivers.train import Loop, compare, hold_grads
from gpubench.reference import densify as ref_densify
from gpubench.reference import render as ref_render
from gpubench.reference import train as ref_train

# The engine's key buffer bookkeeping, restored with the state.
KEY_BUFFER_STATE = ("key_capacity", "_key_buffer_size", "_overflow_backlog",
                    "_overflow_streak", "_shrink_cooldown")
VALUE_LEAVES = ("features_dc", "features_rest", "scaling", "rotation", "opacity")
# The counters the window's log line gives a segment.
LOGGED_COUNTERS = ("graph.", "key_buffer.", "events.densify", "host_syncs")


def start_model(cfg: dict, wl: dict, seed: int, device) -> tuple:
    """(params, degrees): a random ``keep_share`` of the perturbed
    configuration's Gaussians, in their order, and their SH degrees."""
    n = cfg["n_gaussians"]
    gt = scene.gt_scene(cfg["scene"], n, seed, device)
    full = scene.perturbed(gt, cfg["perturb"], seed)
    del gt
    keep = int(round(wl["keep_share"] * n))
    rows = torch.randperm(n, generator=scene.generator(seed + 3, device),
                          device=device)[:keep].sort().values
    params = {k: v[rows].contiguous() for k, v in full.items()}
    return params, scene.sh_degrees(keep, wl["start_sh_shares"], seed, device)


def size_key_buffer(engine, dataset):
    """The key buffer of the views' image size as a run that has stepped
    with the start model holds it (a resumed run starts from the default
    and renders its first steps from truncated entries until a drain
    regrows it): grown by the program's doubling past 1.15 x the largest
    entry count of any view, then shrunk by its own rule toward it."""
    camera = dataset[0]
    with torch.no_grad():
        most = max(int(engine.model.render(dataset[i])["num_rendered"])
                   for i in range(len(dataset)))
    size = engine.key_buffer_for(camera)
    while size < 1.15 * most:
        engine.grow_key_buffer(camera)
        size, last = engine.key_buffer_for(camera), size
        if size == last:
            break
    engine.shrink_key_buffer(camera, most)


def host_trees(trees: dict) -> dict:
    return {g: program.host(t) for g, t in trees.items()}


def _clone(trees: dict) -> dict:
    return {g: {k: v.detach().clone() for k, v in t.items()} for g, t in trees.items()}


def _rng(device):
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def snapshot(trainer, device) -> dict:
    engine = trainer.engine
    return {"trees": _clone(engine.state_trees()), "step": trainer.curr_step,
            "rng": _rng(device),
            "key": {k: copy.deepcopy(getattr(engine, k)) for k in KEY_BUFFER_STATE
                    if hasattr(engine, k)}}


def restore(trainer, loop: Loop, saved: dict, device):
    """The state of ``snapshot`` back in the trainer, the loop at the start
    of its epoch, and the collector emptied, so that each segment meets the
    same collections."""
    engine = trainer.engine
    engine.set_state_trees(_clone(saved["trees"]))
    trainer.curr_step = saved["step"]
    engine.adam.count.fill_(saved["step"])
    for k, v in saved["key"].items():
        setattr(engine, k, copy.deepcopy(v))
    if device.type == "cuda":
        torch.cuda.set_rng_state(saved["rng"], device)
    else:
        torch.set_rng_state(saved["rng"])
    loop.step = 1
    loop.epoch_psnr = []
    gc.collect()


def densification_trainer(trainer):
    """The layer of the trainer that applies the densifier's instructions."""
    t = trainer
    while not hasattr(t, "apply_instruction"):
        t = t.base_trainer
    return t


def run_events(trainer, loop: Loop, order: list, event_steps: list) -> list:
    """Run on from the restored state through each of ``event_steps``:
    before each, hold the state after the step before (on the host); run
    the step and its event, recording the instruction's selections, the
    mercy mask and the split sources' parameters; then keep the state
    after the event. One dict per event."""
    from reduced_3dgs_torch.pruning import trainer as pruning_trainer
    engine = trainer.engine
    layer = densification_trainer(trainer)
    events = []
    for s in event_steps:
        loop.run(s - 1 - trainer.curr_step)
        held = {"trees": host_trees(engine.state_trees()), "count": s - 1,
                "view": order[(loop.step - 1) % len(order)]}
        seen = {}
        apply, mercy = layer.apply_instruction, pruning_trainer.mercy_gaussians

        def recording_apply(instruction):
            if instruction.remove_mask is not None:
                clone = [sp for sp in instruction.appends if sp.copies == 1]
                split = [sp for sp in instruction.appends if sp.copies > 1]
                seen["removed"] = instruction.remove_mask.cpu()
                seen["clone"] = clone[0].select.cpu()
                seen["split"] = split[0].select.cpu()
                params = engine.model.param_dict()
                seen["parents"] = {k: params[k].detach()[split[0].select].cpu()
                                   for k in ("xyz", "rotation", "scaling")}
            return apply(instruction)

        def recording_mercy(*args, **kwargs):
            mask = mercy(*args, **kwargs)
            seen["mercy"] = mask.cpu()
            return mask

        layer.apply_instruction = recording_apply
        pruning_trainer.mercy_gaussians = recording_mercy
        try:
            loop.run(1)
        finally:
            del layer.apply_instruction
            pruning_trainer.mercy_gaussians = mercy
        seen["after"] = host_trees(engine.state_trees())
        events.append({"step": s, "held": held, "program": seen})
    return events


def program_side(seen: dict) -> dict:
    """The program's outcome of one event in ``event_numbers``' form."""
    after = seen["after"]
    removed, clone, split = seen["removed"], seen["clone"], seen["split"]
    kept = int((~removed).sum())
    n_clone, n_split = int(clone.sum()), int(split.sum())
    k = ref_densify.N_SPLIT
    params = after["params"]
    n = params["xyz"].shape[0]
    side = {"clone": clone, "split": split, "removed": removed, "mercy": seen["mercy"],
            "n": n, "consistent": n == kept + n_clone + k * n_split}
    if not side["consistent"]:
        return side
    side["clones"] = {name: v[kept:kept + n_clone] for name, v in params.items()}
    side["children"] = {name: v[kept + n_clone:] for name, v in params.items() if name != "xyz"}
    side["new_m"] = {name: v[kept:] for name, v in after["adam_m"].items()}
    side["new_v"] = {name: v[kept:] for name, v in after["adam_v"].items()}
    parents = seen["parents"]
    offsets = params["xyz"][kept + n_clone:].reshape(n_split, k, 3) - parents["xyz"][:, None]
    q = parents["rotation"] / parents["rotation"].norm(dim=1, keepdim=True).clamp(min=1e-12)
    local = torch.einsum("nkj,nji->nki", offsets, ref_render._quat_rot(q))
    side["draw"] = (local / torch.exp(parents["scaling"])[:, None]).reshape(-1, 3)
    return side


def reference_side(ref: dict) -> dict:
    """A reference event (``reference.densify.event``) in the program's
    place: its masks, count and new rows (zero moments, no draw), and the
    other side of the mercy prune's cliff where it meets one."""
    host = {k: ref[k].cpu() for k in ("clone", "split", "removed", "mercy", "near_densify")}
    if ref["alternative"] is not None:
        host["alternative"] = {k: (v.cpu() if torch.is_tensor(v) else v)
                               for k, v in ref["alternative"].items()}
    host.update(n=ref["n"], consistent=True,
                clones={k: v.cpu() for k, v in ref["clones"].items()},
                children={k: v.cpu() for k, v in ref["children"].items()})
    rows = int(host["clone"].sum()) + ref_densify.N_SPLIT * int(host["split"].sum())
    zeros = {k: torch.zeros((rows,) + tuple(v.shape[1:])) for k, v in ref["clones"].items()}
    host.update(new_m=zeros, new_v=zeros, draw=None)
    return host


def _rank(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.long(), 0) - 1


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    return float((p.double() - r.double()).norm() / max(float(r.double().norm()), 1e-30))


def event_numbers(p: dict, r: dict) -> dict:
    """One event's numbers: the program's outcome ``p`` against the
    reference's ``r`` (``reference_side`` of ``reference.densify.event``).

    The mask gaps count the rows decided differently: by the split and
    clone selections together, over the rows the reference splits or
    clones, leaving out the rows whose densify decision the reference
    finds within round-off of its threshold (``near_densify``); by the
    mercy mask, and by the rows the opacity and size prune
    removes alone (neither split nor mercy removes them; the program's are
    its removals outside both), over the rows the reference moves (removes
    or clones). ``densify_value_gap`` is the worst relative gap, by
    parameter, of the new rows whose source both sides chose, and of their
    Adam moments (zeros) against the sources' moments (``with_source_moments``;
    infinite where the program's rows do not add up to its selections).
    Where the reference's mercy prune meets its cliff, the numbers are
    those of the side nearer the program's mercy mask. The split children's
    offsets in their parent's frame over its scales, the draw, are
    returned for ``draw_z``."""
    if "alternative" in r:
        near = {k: v for k, v in r.items() if k != "alternative"}
        sides = [event_numbers(p, near), event_numbers(p, {**near, **r["alternative"]})]
        return min(sides, key=lambda x: x["mercy_mask_gap"])
    out = {"event_count_gap": abs(p["n"] - r["n"]) / max(r["n"], 1)}
    moved = max(int((r["removed"] | r["clone"]).sum()), 1)
    densified = max(int((r["clone"] | r["split"]).sum()), 1)
    far = ~r["near_densify"]
    out["densify_mask_gap"] = (int(((p["clone"] ^ r["clone"]) & far).sum())
                               + int(((p["split"] ^ r["split"]) & far).sum())) / densified
    out["mercy_mask_gap"] = int((p["mercy"] ^ r["mercy"]).sum()) / moved
    alone_p = p["removed"] & ~p["split"] & ~p["mercy"]
    alone_r = r["removed"] & ~r["split"] & ~r["mercy"]
    out["prune_mask_gap"] = int((alone_p ^ alone_r).sum()) / moved
    if not p["consistent"]:
        out.update(densify_value_gap=float("inf"), draw=None)
        return out
    gaps = []
    k = ref_densify.N_SPLIT
    for key, rows_p, rows_r, leaves in (
            ("clones", *(_common(p["clone"], r["clone"], 1)), ("xyz",) + VALUE_LEAVES),
            ("children", *(_common(p["split"], r["split"], k)), VALUE_LEAVES)):
        for leaf in leaves:
            if rows_p.numel():
                gaps.append(_gap(p[key][leaf][rows_p], r[key][leaf][rows_r]))
    for name in ("new_m", "new_v"):
        for leaf, v in p[name].items():
            scale = float(r["moments_of_sources"][name][leaf].double().norm())
            gaps.append(float(v.double().norm()) / max(scale, 1e-30))
    out["densify_value_gap"] = max(gaps, default=0.0)
    out["draw"] = p["draw"]
    return out


def _common(p_mask, r_mask, copies: int):
    """Rows of the new rows of each side whose source both sides chose, in
    source order (``copies`` rows a source)."""
    both = p_mask & r_mask
    rp, rr = _rank(p_mask)[both], _rank(r_mask)[both]
    j = torch.arange(copies)
    return (rp[:, None] * copies + j).reshape(-1), (rr[:, None] * copies + j).reshape(-1)


def draw_z(draws: list) -> float:
    """The largest |z| of the per-axis means of the standard normal samples
    of every event's ``draws`` [M,3] (against 0) and of their variance over
    all axes (against 1); 0 for too few samples or no draw."""
    draws = [d for d in draws if d is not None]
    if not draws or sum(d.shape[0] for d in draws) < 2:
        return 0.0
    d = torch.cat(draws).double()
    z_mean = d.mean(0) * d.shape[0] ** 0.5
    z_var = (d.flatten().var() - 1.0) * (d.numel() / 2.0) ** 0.5
    return float(torch.cat([z_mean, z_var[None]]).abs().max())


def with_source_moments(side: dict, post: dict) -> dict:
    """``side`` with the reference's Adam moments after the step (``post``)
    of the rows each new row copies, the scale that a copied moment would
    show against."""
    k = ref_densify.N_SPLIT
    clone, split = side["clone"].to(post["accum"].device), side["split"].to(post["accum"].device)
    side["moments_of_sources"] = {
        name: {leaf: torch.cat([v[clone], v[split].repeat_interleave(k, 0)]).cpu()
               for leaf, v in post[key].items()}
        for name, key in (("new_m", "adam_m"), ("new_v", "adam_v"))}
    return side


def worst(readings: list) -> dict:
    """The largest of each number over the events, and ``split_draw_z`` of
    their draws together."""
    out = {k: max(r[k] for r in readings) for k in readings[0] if k != "draw"}
    out["split_draw_z"] = draw_z([r.get("draw") for r in readings])
    return out


def setup(ctx) -> SimpleNamespace:
    """The inputs, the trainer at ``start_step`` and the loop, with the
    state held for the restores: poses, fov, init (the start parameters on
    the host), degrees, trainer, loop, order, saved, steps, event_steps."""
    from reduced_3dgs_torch.dataset.dataset import CameraDataset
    from reduced_3dgs_torch.prepare import prepare_trainer
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    first, last = wl["segment"]
    if first != wl["start_step"] + 1:
        raise ValueError("a segment starts at the step after start_step")
    poses, fov = scene.orbit_views(cfg["views"], cfg["image_height"], cfg["image_width"])
    images = program.ground_truth(cfg, seed, dev, poses, fov)
    program.log(ctx, f"ground truth of {len(images)} views rendered")
    cameras = [program.program_camera(p, cfg, fov, dev, img) for p, img in zip(poses, images)]
    del images
    dataset = CameraDataset(cameras)
    init, degrees = start_model(cfg, wl, seed, dev)
    model = program.build_model(cfg, init, degrees, dev)
    trainer, _ = prepare_trainer(model, dataset, cfg["mode"],
                                 with_scale_reg=cfg["with_scale_reg"], configs=cfg["options"])
    trainer.curr_step = wl["start_step"]
    trainer.engine.adam.count.fill_(wl["start_step"])
    model.active_sh_degree = cfg["sh_degree"]
    size_key_buffer(trainer.engine, dataset)
    order = next(scene.epoch_orders(len(dataset), seed))
    event_steps = [s for s in range(first, last + 1) if trainer.fires_at(s)]
    if not event_steps:
        raise ValueError(f"no event fires in the segment {first}-{last}")
    program.log(ctx, f"start: {model.num_points} Gaussians at step {wl['start_step']}, "
                     f"events after steps {event_steps}")
    return SimpleNamespace(
        poses=poses, fov=fov, init=program.host(init), degrees=degrees, trainer=trainer,
        loop=Loop(trainer, dataset, itertools.repeat(order), wl["window"]), order=order,
        saved=snapshot(trainer, dev), steps=last - first + 1, event_steps=event_steps)


def run(ctx) -> dict:
    cfg, wl, dev, seed = ctx.config, ctx.workload, ctx.device, ctx.seed
    st = setup(ctx)
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
        restore(trainer, loop, st.saved, dev)
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
        restore(trainer, loop, st.saved, dev)
        record = program_trace.traced(lambda: loop.run(wl["trace_steps"]), dev)
        record.update(units=wl["trace_steps"], unit_s=timed / (segments * steps),
                      segments=wl["trace_steps"] / steps)
        program.log(ctx, "traced segment reduced")

    restore(trainer, loop, st.saved, dev)
    events = run_events(trainer, loop, st.order, st.event_steps)
    program.log(ctx, "events held: " + ", ".join(
        f"{e['step']}: {e['program']['after']['params']['xyz'].shape[0]}" for e in events))
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
        program.log(ctx, f"reference compared: {numbers}")
        readings, variants = [], {v: [] for v in wl.get("variants", [])}
        all_views = [ref_render.make_view(rot, t, cfg["image_height"], cfg["image_width"],
                                          fov[0], fov[1], device=dev) for rot, t in poses]
        for e in events:
            va = program.view_args(poses[e["held"]["view"]], cfg, fov)
            gt = program.reference_ground_truth(cfg, seed, dev, [va])[0]
            held = device_state(e["held"], dev)
            post = ref_densify.after_step(held, va, gt, cfg, extent)
            ref = ref_densify.event(post, all_views, cfg, extent, e["step"])
            sound = with_source_moments(reference_side(ref), post)
            readings.append(event_numbers(program_side(e["program"]), sound))
            shown = {k: v for k, v in readings[-1].items() if k != "draw"}
            program.log(ctx, f"event {e['step']}: {shown} (reference: "
                             f"{ref['n']} Gaussians, clone {int(ref['clone'].sum())}, "
                             f"split {int(ref['split'].sum())}, prune {int(ref['prune'].sum())}, "
                             f"mercy {int(ref['mercy'].sum())} above "
                             f"{ref['merciful']['threshold']}, near a threshold {ref['near']}, "
                             f"cliff {ref['alternative'] is not None})")
            for variant in variants:
                if variant == "bf16":
                    low = ref_densify.after_step(held, va, gt, cfg, extent, torch.bfloat16)
                    out = ref_densify.event(low, all_views, cfg, extent, e["step"])
                else:
                    out = ref_densify.event(post, all_views, cfg, extent, e["step"],
                                            fault=variant, merciful=ref["merciful"])
                variants[variant].append(event_numbers(reference_side(out), sound))
            del held, post, ref
            program.release(dev)
        numbers.update(worst(readings))
        numbers["events"] = [{k: v for k, v in r.items() if k != "draw"} for r in readings]
        if variants:
            numbers["variants"] = {v: worst(r) for v, r in variants.items()}
    return {"metrics": {"camera_step_ms": timed / (segments * steps) * 1e3,
                        "setup_s": setup_s},
            "numbers": numbers, "attempted": segments * steps, "failed": failed,
            "memory_peak_bytes": peak, "record": record}


def device_state(held: dict, device) -> dict:
    """A held state on the card in ``reference.densify.event``'s form."""
    trees = held["trees"]
    return {"params": {k: v.to(device) for k, v in trees["params"].items()},
            "adam_m": {k: v.to(device) for k, v in trees["adam_m"].items()},
            "adam_v": {k: v.to(device) for k, v in trees["adam_v"].items()},
            "accum": trees["accum"]["xyz_grad_accum"].to(device),
            "denom": trees["accum"]["denom"].to(device),
            "degrees": trees["aux"]["degrees"].to(device), "count": held["count"]}
