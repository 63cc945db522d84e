"""The reference's binning, compositing and pair counts against a
brute-force walk of every pixel through its tile's entries, one entry at a
time, on a tiny scene; and the operation and byte counts built on them."""
import math

import numpy as np
import pytest
import torch

from gpubench import counts, scene
from gpubench.reference import render as R


def tiny_scene(n=40, seed=3):
    sc = {"sh_degree": 3, "splat_per_spacing": 4.0, "rest_sigma": 0.05,
          "opacity_min": 0.6, "opacity_max": 0.95}
    gt = scene.gt_scene(sc, n, seed, "cpu")
    params = scene.perturbed(gt, {"xyz": 0.25, "features_dc": 0.05, "features_rest": 0.02,
                                  "scaling": 0.1, "rotation": 0.02, "opacity": 0.2}, seed)
    params["scaling"] = params["scaling"] + 2.5          # splats a few tiles wide
    degrees = scene.sh_degrees(n, [0.46, 0.27, 0.16, 0.11], seed, "cpu")
    poses, (fx, fy) = scene.orbit_views({"count": 4, "fovx_deg": 70.0, "radius": 5.2,
                                         "elevation": 0.25, "elevation_wave": 0.2,
                                         "waves": 3}, 40, 56)
    return params, degrees, R.make_view(*poses[1], 40, 56, fx, fy)


def brute_force(params, degrees, view):
    """Per pixel, the sequential walk of its tile's entries in float64."""
    with torch.no_grad():
        pre = R.preprocess(params, degrees, view)
    f = pre["fields"].double().numpy()
    lo, hi, vis, depth = (pre["rect_lo"].numpy(), pre["rect_hi"].numpy(),
                          pre["visible"].numpy(), pre["depth"].numpy())
    tiles_x, tiles_y = view.tiles
    image = np.zeros((view.height, view.width, 3))
    scanned = contributing = entries = 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            ids = [i for i in range(len(f)) if vis[i] and lo[i, 0] <= tx < hi[i, 0]
                   and lo[i, 1] <= ty < hi[i, 1]]
            ids.sort(key=lambda i: (depth[i], i))
            entries += len(ids)
            for py in range(ty * 16, ty * 16 + 16):
                for px in range(tx * 16, tx * 16 + 16):
                    T, c = 1.0, np.zeros(3)
                    for i in ids:
                        scanned += 1
                        x, y, A, B, C, op = f[i, :6]
                        dx, dy = x - px, y - py
                        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
                        if power > 0:
                            continue
                        alpha = min(0.99, op * math.exp(power))
                        if alpha < 1 / 255:
                            continue
                        if T * (1 - alpha) < 1e-4:
                            break
                        contributing += 1
                        c += alpha * T * f[i, 6:9]
                        T *= 1 - alpha
                    if py < view.height and px < view.width:
                        image[py, px] = c
    return image, scanned, contributing, entries


def test_counts_match_a_brute_force_walk():
    params, degrees, view = tiny_scene()
    out = R.render(params, degrees, view, counts=True)
    image, scanned, contributing, entries = brute_force(params, degrees, view)
    assert out["entries"] == entries > 0
    assert out["scanned_pairs"] == scanned
    assert out["contributing_pairs"] == contributing > 0
    got = out["render"].permute(1, 2, 0).double().numpy()
    assert np.abs(got - image).max() < 1e-5


def test_operations_and_bytes_from_the_counts():
    work = {"entries": 1000, "scanned_pairs": 50_000, "contributing_pairs": 20_000,
            "tiles": 12, "pixels": 40 * 56, "gaussians": 40, "degree_counts": [10, 10, 10, 10]}
    assert counts.b1(work) == (50_000 * 13, 1000 * 40 + 12 * 8 + 12 * 256 * 24)
    assert counts.b3(work) == (50_000 * 13 + 20_000 * 27,
                               1000 * 80 + 12 * 8 + 12 * 256 * 28)
    step = counts.train_step_ops(work)
    assert step > counts.b1(work)[0] + counts.b3(work)[0]
    assert counts.render_frame_ops(work) > counts.b1(work)[0]
    share = counts.roofline_share(*counts.b1(work), 1e-3)
    assert share == pytest.approx(100 * max(50_000 * 13 / 67e12,
                                            counts.b1(work)[1] / 3.35e12) / 1e-3)
