"""Plain rendered-importance statistics and pruning rules: the benchmark's
reference for the sweep cell. It imports nothing of the program under test.

The statistics follow reduced-3dgs's importance sweep
(``reduced_3dgs/importance/trainer.py``, over the rasterizer's statistics
pass): every view is rendered as ``render.py`` renders it, and over the
pixels where an entry contributes (gated, and before the entry that ends
the pixel: ``composite_group``'s ``contrib``; the pixels of a tile past the
image's edge count, as a tile covers them) each Gaussian gets, summed over
its entries and the views:

  * count, the pixels it contributes to;
  * count x opacity (each entry's count times the Gaussian's opacity);
  * the sum of its blend weights w = alpha T.

The rules are the reference's ``prune_gaussians`` with the options a
configuration states (``rules``), its defaults where it states none
(``importance/trainer.py:190-200``):

  * ``v_important_score``: count x opacity times (volume over the volume
    ranked at 90% of the way down from the largest) to the power ``v_pow``;
    the volume is the product of the three scales;
  * ``score2mask``: a score is pruned when it is at most the score ranked
    at int(p (N - 1)) from the smallest, clamped to the type's threshold;
  * ``comprehensive``: the OR of the masks of every type with a threshold
    (v_important_score 3.0, count 1, T_alpha 1, T_alpha_avg 0.001).

``view_stats`` gives one view's sums and the compositor's work there,
``sweep`` their totals over views, ``type_masks`` each type's mask and
the rows within ``NEAR`` (relative) of the threshold they meet, which may
fall either way between two implementations, and ``prune_mask`` their
union. Sums are in float64, the rest in the dtype asked for (float32, the
configuration's precision, or bfloat16 for the control). ``FAULTS`` names
the faults the limits are set against.
"""
from __future__ import annotations

import torch

from . import render as R

PRUNE_TYPE = "comprehensive"
PERCENT = 0.1
V_POW = 0.1
THRESHOLDS = {"important_score": None, "v_important_score": 3.0,
              "max_v_important_score": None, "count": 1.0, "T_alpha": 1.0,
              "T_alpha_avg": 0.001}
# How near its threshold (relative) a score lies for its decision to fall
# either way: float32 sums of the same terms in another order differ by
# ~1e-7 relative, a thousandth of this.
NEAR = 1e-5
VOLUME_RANK = 0.9
# The first view left out of the sums; the percentile at twice the
# configuration's (0.2); the T_alpha_avg mask left out of the OR; v_pow at 0.
FAULTS = ("no_first_view", "percent", "no_t_alpha_avg", "no_v_pow")
# The configuration's option of each threshold.
THRESHOLD_OPTIONS = {kind: f"importance_prune_thr_{kind}" for kind in THRESHOLDS}


def _contributions(f, valid, px, py):
    """``composite_group``'s gate and latch over one group: (contrib [b,
    256, L] bool, w = alpha T_in [b, 256, L], pairs scanned)."""
    x, y, A, B, C, op = (f[..., i][:, None, :] for i in range(6))
    dx = x - px[..., None]
    dy = y - py[..., None]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    gate = power <= 0
    raw = op * torch.exp(torch.where(gate, power, torch.zeros_like(power)))
    alpha = torch.where(raw < R.ALPHA_MAX, raw, torch.full_like(raw, R.ALPHA_MAX))
    gate = gate & (alpha >= R.ALPHA_MIN) & valid[:, None, :]
    one_m = 1.0 - torch.where(gate, alpha, torch.zeros_like(alpha))
    prod = torch.cumprod(one_m, dim=-1)
    t_in = torch.cat([torch.ones_like(prod[..., :1]), prod[..., :-1]], dim=-1)
    hits = torch.cumsum((gate & (t_in * one_m < R.T_MIN)).to(torch.int32), dim=-1)
    contrib = gate & (hits == 0)
    w = torch.where(contrib, (1.0 - one_m) * t_in, torch.zeros_like(t_in))
    scanned = (hits == 0).sum(-1) + (hits[..., -1] > 0).to(torch.int64)
    scanned = torch.minimum(scanned, valid.sum(-1)[:, None])
    return contrib, w, int(scanned.sum())


def view_stats(params: dict, degrees, view: R.View, dtype=torch.float32) -> dict:
    """One view's statistics per Gaussian ([N]: ``count`` int64,
    ``opacity`` and ``t_alpha`` float64) and the compositor's work there:
    ``entries``, ``scanned_pairs``, ``contributing_pairs``, ``tiles``,
    ``pixels``."""
    with torch.no_grad():
        pre = R.preprocess(params, degrees, view, dtype=dtype)
        bins = R.bin_entries(pre, view)
        fields = pre["fields"]
        n, device = fields.shape[0], fields.device
        tiles_x, tiles_y = view.tiles
        count = torch.zeros(n, dtype=torch.int64, device=device)
        opacity = torch.zeros(n, dtype=torch.float64, device=device)
        t_alpha = torch.zeros(n, dtype=torch.float64, device=device)
        scanned = contributing = 0
        for tiles, _, pos in R.tile_groups(bins):
            valid = pos >= 0
            gid = bins["gidx"][torch.clamp(pos, min=0)]
            f = fields[gid]
            px, py = R._pixels(tiles, tiles_x, dtype)
            contrib, w, s = _contributions(f, valid, px, py)
            entry_count = contrib.sum(1)                                # [b, L]
            scanned += s
            contributing += int(entry_count.sum())
            g = gid[valid]
            c = entry_count[valid]
            count.index_add_(0, g, c)
            opacity.index_add_(0, g, c.double() * f[..., 5][valid].double())
            t_alpha.index_add_(0, g, w.double().sum(1)[valid])
    return {"count": count, "opacity": opacity, "t_alpha": t_alpha,
            "entries": int(bins["gidx"].numel()), "scanned_pairs": scanned,
            "contributing_pairs": contributing, "tiles": tiles_x * tiles_y,
            "pixels": view.height * view.width}


def sweep(params: dict, degrees, views: list, dtype=torch.float32) -> dict:
    """The statistics summed over ``views`` (``count``, ``opacity``,
    ``t_alpha``), the first view's alone (``first``), and each view's work
    (``work``, the other keys of ``view_stats``)."""
    total, first, work = None, None, []
    for view in views:
        out = view_stats(params, degrees, view, dtype)
        sums = {k: out.pop(k) for k in ("count", "opacity", "t_alpha")}
        work.append(out)
        if total is None:
            first = sums
            total = {k: v.clone() for k, v in sums.items()}
        else:
            for k in total:
                total[k] += sums[k]
    return {**total, "first": first, "work": work}


def scores(count, opacity, t_alpha, scaling, v_pow: float = V_POW,
           dtype=torch.float32) -> dict:
    """Each type's score [N] from the sums and the raw (log) scales."""
    glist = count.to(dtype)
    opacity = opacity.to(dtype)
    t_alpha = t_alpha.to(dtype)
    scales = torch.exp(scaling.to(dtype))
    n = glist.shape[0]
    volume = torch.prod(scales, dim=1)
    kth = torch.sort(volume, descending=True).values[min(int(n * VOLUME_RANK), n - 1)]
    return {
        "important_score": opacity,
        "v_important_score": torch.pow(volume / kth, v_pow) * opacity,
        "max_v_important_score": opacity * scales.max(dim=1).values,
        "count": glist,
        "T_alpha": t_alpha,
        "T_alpha_avg": torch.where(glist > 0, t_alpha / torch.clamp(glist, min=1),
                                   torch.zeros_like(glist)),
    }


def score_mask(score, percent: float, threshold=None) -> tuple:
    """(mask, near): the scores at or under min(threshold, the score ranked
    at int(percent (N - 1))), and the scores within ``NEAR`` of a threshold
    that is not 0 (a score of 0 is a sum of no terms, exact on any side)."""
    thr = torch.sort(score).values[int(percent * (score.shape[0] - 1))]
    if threshold is not None:
        thr = torch.clamp(thr, max=threshold)
    near = ((score - thr).abs() <= NEAR * thr.abs()) & (thr != 0)
    return score <= thr, near


def type_masks(count, opacity, t_alpha, scaling, prune_type: str = PRUNE_TYPE,
               percent: float = PERCENT, thresholds: dict = None, v_pow: float = V_POW,
               dtype=torch.float32) -> dict:
    """{type: (mask, near)} of ``score_mask``: ``prune_type``'s alone, or
    under ``comprehensive`` every type's with a threshold (``THRESHOLDS``
    when not given), in the order of ``thresholds``, which is the order in
    which the reference's ``prune_gaussians`` makes them."""
    thresholds = THRESHOLDS if thresholds is None else thresholds
    each = scores(count, opacity, t_alpha, scaling, v_pow, dtype)
    if prune_type != PRUNE_TYPE:
        return {prune_type: score_mask(each[prune_type], percent, thresholds[prune_type])}
    return {kind: score_mask(each[kind], percent, threshold)
            for kind, threshold in thresholds.items() if threshold is not None}


def union(masks: dict, like: torch.Tensor) -> tuple:
    """(mask, near) of the OR of ``type_masks``' masks, over rows shaped as
    ``like``: near where some type's decision is near and no other type
    prunes the row away from its threshold."""
    mask = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    near, sure = torch.zeros_like(mask), torch.zeros_like(mask)
    for m, close in masks.values():
        mask |= m
        near |= close
        sure |= m & ~close
    return mask, near & ~sure


def prune_mask(count, opacity, t_alpha, scaling, prune_type: str = PRUNE_TYPE,
               percent: float = PERCENT, thresholds: dict = None, v_pow: float = V_POW,
               dtype=torch.float32) -> tuple:
    """(mask, near) of ``prune_type``: ``union`` of its ``type_masks``."""
    return union(type_masks(count, opacity, t_alpha, scaling, prune_type, percent, thresholds,
                            v_pow, dtype), count)


def rules(options: dict) -> dict:
    """``prune_mask``'s keywords from a configuration's ``options``, the
    defaults above where it states none."""
    thresholds = {kind: options.get(key, THRESHOLDS[kind])
                  for kind, key in THRESHOLD_OPTIONS.items()}
    return {"prune_type": options.get("importance_prune_type", PRUNE_TYPE),
            "percent": options.get("importance_prune_percent", PERCENT),
            "thresholds": thresholds, "v_pow": options.get("importance_v_pow", V_POW)}


def faulty_rules(fault: str, sound: dict) -> dict:
    """The keywords ``sound`` (``rules``) under a rule fault of ``FAULTS``;
    ``sound`` itself for the others."""
    if fault == "percent":
        return {**sound, "percent": 2 * sound["percent"]}
    if fault == "no_t_alpha_avg":
        return {**sound, "thresholds": {**sound["thresholds"], "T_alpha_avg": None}}
    if fault == "no_v_pow":
        return {**sound, "v_pow": 0.0}
    return sound
