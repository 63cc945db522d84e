"""Plain densification events: the benchmark's reference for the densify
cell. It imports nothing of the program under test.

One event, by the rules of the reference's ``densify-pruning-shculling``
(vanilla 3DGS's densification and the reduced-3dgs mercy prune) at a step
past 3,000 where densification, the opacity prune and the mercy prune fire
together and nothing else does. From the state held after the step before
(parameters, Adam's moments and count, the densification sums, the SH
degrees):

  1. the step itself on its view (``train.step``), Adam, and the sums: each
     Gaussian of positive radius adds its screen-space gradient norm to its
     sum and one to its count;
  2. split and clone: a Gaussian is hot when its sum over its count (0 when
     the count is 0) is at least ``densify_grad_threshold``; it is cloned
     when its largest scale is at most 0.01 x the scene extent, and split
     otherwise, into 2 children with the same parameters but their
     positions drawn in its frame and their scales divided by 1.6; the
     split resets the sums before the prune reads them;
  3. the prune: opacity below 0.005, a screen radius since the reset above
     20 (none, the reset being just before), or a largest scale above
     0.1 x the extent;
  4. the mercy prune: the world size of one pixel at each centre, smallest
     over every view whose NDC box holds it (10,000 where none does); the
     sphere of half its diagonal (box 1); its 30 nearest neighbours, exact
     (``knn_exact``); the neighbours whose ellipsoid, grown by the sphere's
     radius, holds the centre in the centre's own rotation frame, plus one;
     each Gaussian's smallest such count over itself and the Gaussians that
     list it as intersecting; redundant above max(mean + std (ddof 1), 3);
     and of the redundant ones those whose opacity lies below their median
     (a whole-number metric against a threshold: where the threshold lies
     near a whole number, ``mercy`` gives both sides of it);
  5. the event removes the union of the split's sources and both prunes
     over the rows before it, and appends the clones, then the split
     children, in source order; new rows have zero Adam moments.

``after_step`` takes step 1 and ``event`` the rest: each decision and the
values of the new rows that no random draw sets. ``FAULTS`` plants, for
the limits, what a faulty event would do. Statistics are in float64 and
the rest in float32.
"""
from __future__ import annotations

import math

import torch

from . import render as R
from . import train as T

PERCENT_DENSE = 0.01
N_SPLIT = 2
SPLIT_DIVISOR = 0.8 * N_SPLIT
PRUNE_OPACITY = 0.005
PRUNE_SCREEN = 20.0
PRUNE_BIG = 0.1
PRUNE_BIG_FROM = 3000
NEIGHBOURS = 30
BOX = 1.0
LAMBDA_MERCY = 1.0
MERCY_MINIMUM = 3
UNSEEN = 10000.0
# How near a whole number mean + std may lie for the rows at it to count on
# either side (the program's approximate neighbours move it by ~0.01-0.05).
CLIFF = 0.1
FAULTS = ("no_mercy", "split_scale", "opacity_threshold", "no_clones")


# --------------------------------------------------------------------- KNN
def _brute_force(points, queries, k):
    """Exact k smallest squared distances of the points at ``queries`` (ids)
    to every other point, by blocks of queries: (d [Q,k], ids [Q,k])."""
    n = points.shape[0]
    rows = max(1, (1 << 27) // max(n, 1))
    ds, ids = [], []
    for q0 in range(0, queries.shape[0], rows):
        q = queries[q0:q0 + rows]
        diff = points[q][:, None, :] - points[None, :, :]
        dist = (diff * diff).sum(-1)
        dist[torch.arange(q.shape[0], device=points.device), q] = float("inf")
        d, i = torch.topk(dist, k, dim=1, largest=False)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def knn_exact(points: torch.Tensor, k: int, sample: int = 4096) -> torch.Tensor:
    """Ids [N,k] of each point's k nearest other points, exact, nearest
    first. A uniform grid whose cell is the 90th percentile of a sample's
    k-th neighbour distance holds candidates; every point within one cell
    of a query lies in the 27 cells around it, so a query whose k-th
    distance is at most the cell, and none of whose cells was cut short, is
    exact; the others are searched by brute force."""
    n, dev = points.shape[0], points.device
    pts = points.float()
    probe = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:sample].to(dev)
    kth = _brute_force(pts, probe, k)[0][:, -1].sqrt()
    h = float(torch.quantile(kth, 0.9)) * 1.0001 + 1e-12
    lo = pts.min(0).values
    cell = ((pts - lo) / h).floor().long()
    dims = cell.max(0).values + 3
    key = ((cell[:, 0] + 1) * dims[1] + cell[:, 1] + 1) * dims[2] + cell[:, 2] + 1
    key_sorted, order = torch.sort(key)
    cells, counts = torch.unique_consecutive(key_sorted, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    cap = int(min(int(counts.max()), 64))
    offsets = torch.stack(torch.meshgrid(*[torch.arange(-1, 2, device=dev)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    shift = (offsets[:, 0] * dims[1] + offsets[:, 1]) * dims[2] + offsets[:, 2]
    ids = torch.empty((n, k), dtype=torch.long, device=dev)
    exact = torch.zeros(n, dtype=torch.bool, device=dev)
    rows = max(1, (1 << 25) // (27 * cap))
    slot = torch.arange(cap, device=dev)
    for r0 in range(0, n, rows):
        q = torch.arange(r0, min(n, r0 + rows), device=dev)
        nb = key[q][:, None] + shift[None, :]                                  # [Q,27]
        at = torch.searchsorted(cells, nb).clamp(max=cells.numel() - 1)
        found = cells[at] == nb
        count = torch.where(found, counts[at], torch.zeros_like(at))
        first = starts[at]
        cand_pos = first[..., None] + slot                                     # [Q,27,cap]
        valid = slot < count[..., None]
        cand = order[cand_pos.clamp(max=n - 1)].reshape(q.shape[0], -1)
        valid = valid.reshape(q.shape[0], -1) & (cand != q[:, None])
        diff = pts[q][:, None, :] - pts[cand]
        dist = torch.where(valid, (diff * diff).sum(-1), torch.full_like(valid, float("inf"),
                                                                         dtype=pts.dtype))
        d, pos = torch.topk(dist, k, dim=1, largest=False)
        ids[q] = torch.gather(cand, 1, pos)
        exact[q] = (d[:, -1] <= (0.999 * h) ** 2) & (count.max(1).values <= cap)
    rest = torch.nonzero(~exact).flatten()
    if rest.numel():
        ids[rest] = _brute_force(pts, rest, k)[1]
    return ids


# ---------------------------------------------------------------- redundancy
def pixel_sizes(xyz: torch.Tensor, views: list) -> torch.Tensor:
    """[N] the world size of one pixel at each centre, smallest over the
    views whose NDC box ([-1,1]^2 x [0,1]) holds it: the distance between
    the unprojections, at the centre's NDC depth, of the image centre and
    of one pixel along the longer side."""
    size = torch.full((xyz.shape[0],), UNSEEN, dtype=xyz.dtype, device=xyz.device)
    ones = torch.ones_like(xyz[:, :1])
    for v in views:
        fp = v.full_proj.float()
        inv = torch.linalg.inv(fp)
        hom = R._transform(xyz, fp)
        ndc = hom[:, :3] * (1.0 / (hom[:, 3:4] + 1e-7))
        inside = ((ndc[:, 0].abs() <= 1) & (ndc[:, 1].abs() <= 1) & (ndc[:, 2] >= 0)
                  & (ndc[:, 2] <= 1))
        z = ndc[:, 2:3]
        step = (2.0 / v.width, 0.0) if v.width > v.height else (0.0, 2.0 / v.height)

        def unproject(x, y):
            p = torch.cat([ones * x, ones * y, z], 1)
            back = R._transform(p, inv)
            return back[:, :3] / (back[:, 3:4] + 1e-7)

        d = unproject(*step) - unproject(0.0, 0.0)
        size = torch.where(inside, torch.minimum(size, d.norm(dim=1)), size)
    return size


def redundancy(xyz, scaling, rotation, neighbours, radius) -> torch.Tensor:
    """[N] each Gaussian's smallest count of intersecting neighbours plus
    one, over itself and the Gaussians that list it as intersecting."""
    n, k = neighbours.shape
    scales = torch.exp(scaling)
    rot = R._quat_rot(rotation / rotation.norm(dim=1, keepdim=True).clamp(min=1e-12))
    hits = torch.empty((n, k), dtype=torch.bool, device=xyz.device)
    rows = max(1, (1 << 24) // k)
    for r0 in range(0, n, rows):
        nb = neighbours[r0:r0 + rows]
        local = torch.einsum("nki,nij->nkj", xyz[r0:r0 + rows, None] - xyz[nb],
                             rot[r0:r0 + rows])
        grown = scales[nb] + radius[r0:r0 + rows, None, None]
        hits[r0:r0 + rows] = ((local * local) / (grown * grown)).sum(-1) < 1.0
    count = hits.sum(1).int() + 1
    metric = count.clone()
    return metric.scatter_reduce_(0, neighbours[hits], count[:, None].expand(n, k)[hits],
                                  reduce="amin")


def _merciful(metric, opacity, threshold: float) -> torch.Tensor:
    """The redundant rows (``metric`` above ``threshold``) whose opacity lies
    below the redundant rows' median."""
    redundant = metric > threshold
    chosen = torch.sort(opacity[redundant]).values
    if chosen.numel() == 0:
        return redundant
    median = (chosen[(chosen.numel() - 1) // 2] + chosen[chosen.numel() // 2]) * 0.5
    return redundant & (opacity < median)


def mercy(xyz, scaling, rotation, opacity_logit, views) -> dict:
    """The mercy prune: ``mask`` [N] bool, its removals, and ``threshold``.
    The metric is a whole number, so where mean + std lies within ``CLIFF``
    of a whole number k above the minimum, the rows at k fall on either
    side of it with the program's approximate neighbours: ``alternative``
    is then the mask with them on the other side (else None)."""
    radius = pixel_sizes(xyz, views) * BOX * math.sqrt(3.0) / 2.0
    metric = redundancy(xyz, scaling, rotation, knn_exact(xyz, NEIGHBOURS), radius).double()
    n = metric.numel()
    mean = metric.mean()
    std = torch.sqrt(((metric - mean) ** 2).sum() / max(n - 1, 1))
    spread = float(mean + LAMBDA_MERCY * std)
    threshold = max(spread, float(MERCY_MINIMUM))
    opacity = torch.sigmoid(opacity_logit[:, 0])
    k = round(spread)
    alternative = None
    if abs(spread - k) < CLIFF and k > MERCY_MINIMUM:
        alternative = _merciful(metric, opacity, k + 0.5 if spread < k else k - 0.5)
    return {"mask": _merciful(metric, opacity, threshold), "alternative": alternative,
            "threshold": threshold}


# --------------------------------------------------------------------- event
def after_step(held: dict, view_args: dict, gt, cfg: dict, extent: float,
               dtype=torch.float32) -> dict:
    """The step from ``held`` (params, adam_m, adam_v, count, accum, denom,
    degrees; on the card) on its view, in ``dtype``: the parameters and
    moments after it and the densification sums (float64) with it."""
    lr = cfg["learning_rates"]
    params = {k: v.detach().clone().float() for k, v in held["params"].items()}
    m = {k: v.clone() for k, v in held["adam_m"].items()}
    v2 = {k: v.clone() for k, v in held["adam_v"].items()}
    _, grads, screen, _ = T.step(params, held["degrees"], view_args, gt, cfg, dtype)
    view = R.make_view(view_args["rot"], view_args["t"], view_args["height"],
                       view_args["width"], view_args["fovx"], view_args["fovy"],
                       device=params["xyz"].device)
    with torch.no_grad():
        visible = R.preprocess(params, held["degrees"], view, dtype=dtype)["radii"] > 0
        rates = {"xyz": T.xyz_lr(lr, extent, held["count"]), "features_dc": lr["feature_lr"],
                 "features_rest": lr["feature_lr"] / 20.0, "opacity": lr["opacity_lr"],
                 "scaling": lr["scaling_lr"], "rotation": lr["rotation_lr"]}
        for k in T.PARAM_NAMES:
            T.adam(params[k], grads[k], m[k], v2[k], held["count"] + 1, rates[k])
    return {"params": params, "adam_m": m, "adam_v": v2,
            "accum": held["accum"].double() + screen.double(),
            "denom": held["denom"].double() + visible.double()}


def _near(values: torch.Tensor, threshold: float, rel: float = 1e-5) -> torch.Tensor:
    return (values.double() / threshold - 1.0).abs() < rel


@torch.no_grad()
def event(post: dict, views: list, cfg: dict, extent: float, step: int,
          fault: str = None, merciful: torch.Tensor = None) -> dict:
    """The event after the step (``after_step``'s ``post``): the masks over
    the rows before it (``clone``, ``split``, ``prune``, ``mercy``,
    ``removed``), ``n`` after it, the new rows' values (``clones``,
    ``children``: by parameter, the position left out of the children),
    ``near``, the count of rows whose densify or prune decision lies within
    1e-5 (relative) of its threshold, where round-off could turn it, and
    ``near_densify``, the mask of those whose densify decision does. ``fault``
    is one of ``FAULTS``; ``merciful`` a ``mercy`` computed already. Where
    the mercy prune meets its cliff (``mercy``), ``alternative`` holds the
    event's ``mercy``, ``removed`` and ``n`` with the rows at it on the
    other side."""
    params = post["params"]
    denom = post["denom"]
    mean_grad = torch.where(denom > 0, post["accum"] / denom.clamp(min=1),
                            torch.zeros_like(denom))
    largest = torch.exp(params["scaling"]).max(1).values
    grad_threshold = cfg["options"]["densify_grad_threshold"]
    hot = mean_grad >= grad_threshold
    clone = hot & (largest <= PERCENT_DENSE * extent)
    split = hot & (largest > PERCENT_DENSE * extent)
    opacity = torch.sigmoid(params["opacity"][:, 0])
    prune = opacity < (0.05 if fault == "opacity_threshold" else PRUNE_OPACITY)
    prune |= torch.zeros_like(largest) > PRUNE_SCREEN        # the radii, just reset
    if step > PRUNE_BIG_FROM:
        prune |= largest > PRUNE_BIG * extent
    if fault == "no_mercy":
        merciful = {"mask": torch.zeros_like(prune), "alternative": None, "threshold": None}
    elif merciful is None:
        merciful = mercy(params["xyz"], params["scaling"], params["rotation"],
                         params["opacity"], views)
    near_densify = (_near(mean_grad, grad_threshold)
                    | (hot & _near(largest, PERCENT_DENSE * extent)))
    near = (int(near_densify.sum()) + int(_near(opacity, PRUNE_OPACITY).sum())
            + int(_near(largest, PRUNE_BIG * extent).sum()))
    if fault == "no_clones":
        clone = torch.zeros_like(clone)
    added = int(clone.sum()) + N_SPLIT * int(split.sum())
    removed = split | prune | merciful["mask"]
    divisor = 0.8 if fault == "split_scale" else SPLIT_DIVISOR
    clones = {k: v[clone] for k, v in params.items()}
    children = {k: v[split].repeat_interleave(N_SPLIT, 0) for k, v in params.items()
                if k != "xyz"}
    children["scaling"] = torch.log(torch.exp(children["scaling"]) / divisor)
    out = {"clone": clone, "split": split, "prune": prune, "mercy": merciful["mask"],
           "removed": removed, "n": int((~removed).sum()) + added, "near": near,
           "near_densify": near_densify,
           "clones": clones, "children": children, "merciful": merciful,
           "alternative": None}
    if merciful["alternative"] is not None:
        other = split | prune | merciful["alternative"]
        out["alternative"] = {"mercy": merciful["alternative"], "removed": other,
                              "n": int((~other).sum()) + added}
    return out
