"""PyTorch port vs JAX package: the 2DGS (surfel) renderer
(ops/rasterize/twodgs.py) and its model classes.

  * ``preprocess_2dgs`` on a random flat cloud: integer fields and
    rectangles exact (after margins on every rounding), float fields within
    1e-5.
  * ``render_tiled_2dgs``: render, final_T and normal within atol 1e-4,
    depth and distortion within 5e-4; the gradients of the five inputs and
    of ``mean2d_offset_ndc`` within rtol 2e-3 / atol 3e-5 of max|g|; the
    ``with_stats`` counts exact and scores within 1e-4. Before comparing,
    every decision on the last bit (the low-pass choice rho3d <= rho2d, the
    alpha gate and clamp, the near cull, the latch, the |s_z| guard) is
    held to a 1e-5 margin, computed in float64 from the port's fields.
  * The JAX package's closed-form cases (tests/test_twodgs.py:32-110): the
    head-on disk, the tilted disk's varying depth, the normal facing the
    camera.
  * Tile independence: a late tile's pixels equal a render of only the
    Gaussians that cover it; the JAX side's float32 running sums fail it.
  * The gradients of the camera's matrices and centre (viewmatrix,
    projmatrix, campos) through all five outputs, within the input
    gradients' bars: they reach M, md, the depths, the normal and the SH
    directions.
  * Checkpointed and unchecked pixel chunks give equal gradients; the 2DGS
    model renders through the surfel renderer and launches no compositor.
  * One step of the camera trainer over the 2DGS model with depth
    supervision (the ``camera-*`` modes' gradient, ``gcam``, the 7 delta
    components) from a delta and Adam state carried across from the JAX
    trainer: the loss within rtol 1e-5 and ``gcam`` within the gradient
    bars, after the render's and the depth term's decision margins at the
    adjusted camera.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reduced_3dgs_torch.ops.rasterize import composite  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import twodgs as t2  # noqa: E402
from reduced_3dgs_torch.ops.rasterize.tiled import bin_and_sort  # noqa: E402
from reduced_3dgs_tpu.ops.rasterize import twodgs as j2  # noqa: E402

from .test_torch_fixtures import (activated_np, assert_decision_margin, camera_np,  # noqa: E402
                                  jax_args, jax_settings, random_cloud_np, torch_args,
                                  torch_settings)

H = W = 48
SH_DEGREE = 2
OUTPUTS = ("render", "final_T", "depth", "normal", "distortion")
ATOL = {"render": 1e-4, "final_T": 1e-4, "normal": 1e-4, "depth": 5e-4, "distortion": 5e-4}
INPUTS = ("xyz", "opacity", "scales", "rotations", "shs", "mean2d_offset_ndc")


def flat_cloud(seed, n, **kw):
    """Activated inputs of n random surfels (the z scale collapsed), with
    scales large enough that most cover several pixels."""
    kw.setdefault("scale_lo", -3.0)
    kw.setdefault("scale_hi", -1.8)
    params, _ = random_cloud_np(seed, n, **kw)
    params["scaling"][:, 2] = -10.0
    return activated_np(params)


def pair_terms(pre, ent, tiles_x):
    """Per (sorted entry, tile pixel) quantities in float64 from the port's
    fields: |s_z|, rho3d, rho2d, op G, the pixel depth, the gate and T_in (1
    - alpha) of the entries a pixel reaches before its latch."""
    f = {k: v.detach().double().numpy() for k, v in pre.items() if v.is_floating_point()}
    gidx, tile = ent["s_gidx"].numpy(), ent["s_tile"].numpy()
    M, md, c2d, op = f["M"][gidx], f["md"][gidx], f["center2d"][gidx], f["opacity"][gidx]
    p = np.arange(256)
    px = ((tile % tiles_x) * 16)[:, None] + (p % 16)[None, :]
    py = ((tile // tiles_x) * 16)[:, None] + (p // 16)[None, :]
    k = px[..., None] * M[:, None, 2, :] - M[:, None, 0, :]
    ll = py[..., None] * M[:, None, 2, :] - M[:, None, 1, :]
    s = np.cross(k, ll)
    sz = np.where(np.abs(s[..., 2]) < 1e-9, 1e-9, s[..., 2])
    u, v = s[..., 0] / sz, s[..., 1] / sz
    rho3 = u * u + v * v
    rho2 = ((px - c2d[:, 0:1]) ** 2 + (py - c2d[:, 1:2]) ** 2) / 0.5
    use3 = rho3 <= rho2
    g_op = op[:, None] * np.exp(-0.5 * np.minimum(rho3, rho2))
    depth = np.where(use3, md[:, None, 0] * u + md[:, None, 1] * v + md[:, None, 2],
                     md[:, None, 2])
    alpha = np.minimum(0.99, g_op)
    gate = (alpha >= 1 / 255) & (depth > 0.2)
    abar = np.where(gate, alpha, 0.0)
    t_after = np.zeros_like(abar)
    reached = np.zeros_like(gate)
    for t0, t1 in zip(ent["range_start"].numpy(), ent["range_end"].numpy()):
        T = np.ones(256)
        live = np.ones(256, bool)
        for i in range(t0, t1):
            t_after[i] = T * (1 - abar[i])
            reached[i] = live
            trig = gate[i] & live & (t_after[i] < 1e-4)
            live &= ~trig
            T = np.where(gate[i] & live, t_after[i], T)
    return dict(sz=np.abs(s[..., 2]), rho3=rho3, rho2=rho2, g_op=g_op, depth=depth, gate=gate,
                t_after=t_after, reached=reached)


def assert_render_margins(pre, ent, tiles_x):
    """Every last-bit decision of the compositor holds a 1e-5 margin."""
    d = pair_terms(pre, ent, tiles_x)
    assert_decision_margin(d["g_op"], 1 / 255)
    assert_decision_margin(d["g_op"], 0.99)
    seen = d["g_op"] >= 0.5 / 255
    assert_decision_margin(d["depth"][seen], 0.2)
    assert_decision_margin((d["rho3"] / d["rho2"])[seen], 1.0)
    assert_decision_margin(d["sz"][seen], 1e-9)
    assert (d["sz"][seen] > 1e-6 * d["sz"].max()).all()  # no splat edge-on
    assert_decision_margin(d["t_after"][d["gate"] & d["reached"]], 1e-4)
    return d


def j_render(arrays, settings, **kw):
    return j2.render_tiled_2dgs(*jax_args(arrays), settings, **kw)


def cotangents(seed):
    rng = np.random.default_rng(seed)
    return {"render": rng.normal(size=(3, H, W)), "final_T": rng.normal(size=(H, W)),
            "depth": rng.normal(size=(H, W)), "normal": rng.normal(size=(3, H, W)),
            "distortion": rng.normal(size=(H, W))}


@pytest.fixture(scope="module")
def case():
    """The random flat cloud, its settings in both packages, JAX's render,
    gradients and statistics, and the port's fields and entries."""
    arrays = flat_cloud(3, 64)
    cam = camera_np(H, W, bg=(0.2, 0.4, 0.6))
    js, ts = jax_settings(cam, SH_DEGREE), torch_settings(cam, SH_DEGREE)
    cot = cotangents(5)
    offset = np.zeros((64, 2), np.float32)

    def loss(*a):
        out = j2.render_tiled_2dgs(*a[:5], js, mean2d_offset_ndc=a[5])
        return sum(jnp.sum(out[k] * jnp.asarray(cot[k], jnp.float32)) for k in OUTPUTS)

    j_grads = jax.grad(loss, argnums=tuple(range(6)))(*jax_args(arrays + (offset,)))
    pre = t2.preprocess_2dgs(*torch_args(arrays), ts)
    tiles_x = (W + 15) // 16
    ent = bin_and_sort(pre["rect_min"], pre["rect_max"], pre["tiles_touched"], pre["depths"],
                       tiles_x, (H + 15) // 16)
    return dict(arrays=arrays, js=js, ts=ts, cot=cot, offset=offset,
                j_out=j_render(arrays, js), j_stats=j_render(arrays, js, with_stats=True),
                j_pre=j2.preprocess_2dgs(*jax_args(arrays), js),
                j_grads=[np.asarray(g) for g in j_grads], pre=pre, ent=ent, tiles_x=tiles_x)


def test_preprocess_matches_jax(case):
    """Rectangles and radii are roundings of pixel boxes: each box edge /16
    and each half-extent is first held to a margin from the integers."""
    pre, jpre = case["pre"], case["j_pre"]
    for key, v in pre.items():
        jv = np.asarray(jpre[key])
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(v.numpy(), jv, err_msg=key)
    assert int(pre["tiles_touched"].sum()) > 64  # most splats span several tiles
    # Margins of the roundings, from the corner boxes recomputed in float64.
    arrays = [a.astype(np.float64) for a in case["arrays"]]
    ts = case["ts"]
    P = ts.projmatrix.double().numpy()
    M = pre["M"].double().numpy()
    c2d = M[:, 0:2, 2] / M[:, 2:3, 2]
    R = t2.proj.quat_to_rotmat(torch.from_numpy(arrays[3])).numpy()
    tu, tv = R[..., :, 0] * arrays[2][:, 0:1], R[..., :, 1] * arrays[2][:, 1:2]
    op = 1 / (1 + np.exp(-arrays[1][:, 0]))
    for cut in (np.full(64, 3.0),
                np.minimum(3.0, np.sqrt(np.maximum(2 * np.log(255 * np.maximum(op, 1e-6)), 0)))):
        # The rectangles truncate lo / 16 and floor hi / 16 (in tiles).
        corners = arrays[0][:, None] + cut[:, None, None] * np.stack(
            [tu + tv, tu - tv, -tu + tv, -tu - tv], 1)
        ch = corners @ P[:3] + P[3]
        cw = np.maximum(ch[..., 3], 1e-4)
        cx, cy = ((ch[..., 0] / cw + 1) * W - 1) / 2, ((ch[..., 1] / cw + 1) * H - 1) / 2
        lp = np.ceil(cut * math.sqrt(0.5))
        lo = np.stack([np.minimum(cx.min(1), c2d[:, 0] - lp),
                       np.minimum(cy.min(1), c2d[:, 1] - lp)])
        hi = np.stack([np.maximum(cx.max(1), c2d[:, 0] + lp),
                       np.maximum(cy.max(1), c2d[:, 1] + lp)])
        for edge in (lo / 16, hi / 16):
            frac = np.abs(edge - np.round(edge))
            assert (frac > 1e-5).all(), edge[frac <= 1e-5]
        if cut[0] == 3.0:
            # The radii: ceil of the half extent at the 3-unit cut, except
            # where the low-pass pad (an integer) is the extent on both sides.
            half = 0.5 * np.maximum(hi[0] - lo[0], hi[1] - lo[1])
            box = np.abs(half - lp) > 1e-3
            assert (np.abs(half - np.round(half)) > 1e-5 * half)[box].all()


def test_render_matches_jax(case):
    out = t2.render_tiled_2dgs(*torch_args(case["arrays"]), case["ts"])
    assert_render_margins(case["pre"], case["ent"], case["tiles_x"])
    assert out["num_rendered"] == int(case["j_out"]["num_rendered"])
    for key in OUTPUTS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(case["j_out"][key]),
                                   rtol=0, atol=ATOL[key], err_msg=key)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(case["j_out"]["radii"]))
    assert float(out["distortion"].abs().max()) > 1e-3  # overlapping surfels
    assert float((1 - out["final_T"]).max()) > 0.5


def torch_grads(case):
    args = [torch.tensor(a, requires_grad=True) for a in case["arrays"] + (case["offset"],)]
    out = t2.render_tiled_2dgs(*args[:5], case["ts"], mean2d_offset_ndc=args[5])
    loss = sum(torch.sum(out[k] * torch.tensor(case["cot"][k], dtype=torch.float32))
               for k in OUTPUTS)
    loss.backward()
    return [a.grad for a in args]


def test_gradients_match_jax(case):
    assert_render_margins(case["pre"], case["ent"], case["tiles_x"])
    for name, g, jg in zip(INPUTS, torch_grads(case), case["j_grads"]):
        assert float(np.abs(jg).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=2e-3, atol=3e-5 * np.abs(jg).max(),
                                   err_msg=name)


CAMERA_FIELDS = ("viewmatrix", "projmatrix", "campos")


def test_camera_matrix_gradients_match_jax(case):
    """The loss of test_gradients_match_jax differentiated in the settings'
    camera tensors, which the camera trainer's delta reaches."""
    js, ts = case["js"], case["ts"]
    cot = case["cot"]

    def loss(*cam):
        out = j2.render_tiled_2dgs(*jax_args(case["arrays"]),
                                   js._replace(**dict(zip(CAMERA_FIELDS, cam))))
        return sum(jnp.sum(out[k] * jnp.asarray(cot[k], jnp.float32)) for k in OUTPUTS)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(*(getattr(js, f) for f in CAMERA_FIELDS))
    cam = {f: getattr(ts, f).clone().requires_grad_(True) for f in CAMERA_FIELDS}
    out = t2.render_tiled_2dgs(*torch_args(case["arrays"]), ts._replace(**cam))
    sum(torch.sum(out[k] * torch.tensor(cot[k], dtype=torch.float32)) for k in OUTPUTS).backward()
    assert_render_margins(case["pre"], case["ent"], case["tiles_x"])
    # The normal's flip toward the camera is a decision on its view z.
    assert float(case["pre"]["normal_view"][:, 2].abs().min()) > 1e-4
    for name, jg in zip(CAMERA_FIELDS, j_grads):
        jg = np.asarray(jg)
        assert float(np.abs(jg).max()) > 0, name
        np.testing.assert_allclose(cam[name].grad.numpy(), jg, rtol=2e-3,
                                   atol=3e-5 * np.abs(jg).max(), err_msg=name)


def test_checkpointed_chunks_give_equal_gradients(case, monkeypatch):
    calls = []

    def unchecked(fn, *args, **kwargs):
        calls.append(kwargs)
        return fn(*args)

    checked = torch_grads(case)
    monkeypatch.setattr(t2, "checkpoint", unchecked)
    plain = torch_grads(case)
    assert calls and all(kw == {"use_reentrant": False, "preserve_rng_state": False}
                         for kw in calls)
    for name, a, b in zip(INPUTS, checked, plain):
        assert torch.equal(a, b), name


def test_stats_match_jax(case):
    out = t2.render_tiled_2dgs(*torch_args(case["arrays"]), case["ts"], with_stats=True)
    j = case["j_stats"]
    assert_render_margins(case["pre"], case["ent"], case["tiles_x"])
    for key in ("gaussians_count", "touched_pixels"):
        assert out[key].dtype == torch.int32
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(j[key]), err_msg=key)
    assert int(out["gaussians_count"].sum()) > 0
    for key in ("opacity_important_score", "T_alpha_important_score", "transmittance_sum"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(j[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    for key in OUTPUTS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(j[key]), rtol=0,
                                   atol=ATOL[key], err_msg=key)


# ------------------------------------------------------ closed-form cases
def single(xyz, rotation, scales, opacity, colour):
    return (np.array([xyz], np.float32), np.array([[opacity]], np.float32),
            np.array([scales], np.float32), np.array([rotation], np.float32),
            np.full((1, 1, 3), colour, np.float32))


def test_head_on_disk_center_hit():
    """A camera-facing disk at the image centre: the rays of the four
    centre pixels hit it where G is computed in closed form from M, so
    final T = 1 - min(0.99, sigmoid(op) G) and the depth is that weight
    times the plane depth."""
    ts = torch_settings(camera_np(32, 32), sh_degree=0)
    z = 4.0
    arrays = single([0.0, 0.0, z], [1.0, 0, 0, 0], [0.5, 0.5, 1e-6], 2.0, 0.5)
    out = t2.render_tiled_2dgs(*torch_args(arrays), ts)
    M = t2.preprocess_2dgs(*torch_args(arrays), ts)["M"][0].double().numpy()
    opa = 1 / (1 + math.exp(-2.0))
    for py, px in [(15, 15), (15, 16), (16, 15), (16, 16)]:
        s = np.cross(px * M[2] - M[0], py * M[2] - M[1])
        g = math.exp(-0.5 * ((s[0] / s[2]) ** 2 + (s[1] / s[2]) ** 2))
        w = min(0.99, opa * g)
        assert abs(float(out["final_T"][py, px]) - (1 - w)) < 1e-5
        assert abs(float(out["depth"][py, px]) - w * z) < 1e-4


def test_tilted_disk_depth_varies():
    """A disk tilted 55 degrees about y: the mean intersection depth spans
    more than 0.3 and differs between the image's left and right."""
    ts = torch_settings(camera_np(64, 64), sh_degree=0)
    a = math.radians(55.0)
    arrays = single([0.0, 0.0, 3.0], [math.cos(a / 2), 0.0, math.sin(a / 2), 0.0],
                    [1.2, 1.2, 1e-6], 6.0, 0.8)
    out = t2.render_tiled_2dgs(*torch_args(arrays), ts)
    T = out["final_T"].numpy()
    hit = T < 0.8
    assert hit.sum() > 50
    mean_depth = np.where(hit, out["depth"].numpy() / np.maximum(1 - T, 1e-9), 0.0)
    assert mean_depth[hit].max() - mean_depth[hit].min() > 0.3
    left, right = mean_depth[:, :28][hit[:, :28]], mean_depth[:, 36:][hit[:, 36:]]
    assert abs(left.mean() - right.mean()) > 0.1


def test_normal_map_faces_camera():
    ts = torch_settings(camera_np(32, 32), sh_degree=0)
    arrays = single([0.0, 0.0, 3.0], [1.0, 0, 0, 0], [0.8, 0.8, 1e-6], 8.0, 0.8)
    out = t2.render_tiled_2dgs(*torch_args(arrays), ts)
    assert float(out["normal"][2, 16, 16]) < -0.5


# ------------------------------------------------------ tile independence
def tile_scene():
    """600 opaque surfels over the image's top rows, whose entries come
    before a late tile's in the sorted buffer, and 12 half-transparent
    surfels over the bottom-right tile (row 2, column 3 of a 48x64 image)."""
    rng = np.random.default_rng(9)
    n_fill, n_late = 600, 12
    xy = np.concatenate([np.stack([rng.uniform(-0.6, 0.6, n_fill), rng.uniform(-0.4, -0.3, n_fill)],
                                  1),
                         np.stack([rng.uniform(0.36, 0.48, n_late), rng.uniform(0.2, 0.34, n_late)],
                                  1)])
    z = np.concatenate([rng.uniform(2.5, 3.5, n_fill), rng.uniform(2.9, 3.1, n_late)])
    xyz = np.concatenate([xy * z[:, None], z[:, None]], 1).astype(np.float32)
    opacity = np.concatenate([np.full(n_fill, 8.0), rng.uniform(-1.0, 1.0, n_late)])[:, None]
    scales = np.concatenate([np.full((n_fill, 2), 0.3), np.full((n_late, 2), 0.06)])
    scales = np.concatenate([scales, np.full((n_fill + n_late, 1), 1e-6)], 1)
    rot = rng.normal(0, 0.1, (n_fill + n_late, 4)) + np.array([1.0, 0, 0, 0])
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    shs = rng.uniform(0.2, 1.0, (n_fill + n_late, 1, 3))
    return tuple(a.astype(np.float32) for a in (xyz, opacity, scales, rot, shs))


def late_tile_error(render_fn, arrays, settings, tile_rows):
    """max |full render - render of the covering Gaussians| over the last
    tile's pixels, and the entries sorted before that tile."""
    pre = t2.preprocess_2dgs(*torch_args(arrays), torch_settings(settings, 0))
    tiles_x = (settings["width"] + 15) // 16
    tx, ty = tiles_x - 1, tile_rows - 1
    lo, hi, seen = pre["rect_min"].numpy(), pre["rect_max"].numpy(), pre["tiles_touched"].numpy()
    cover = (seen > 0) & (lo[:, 0] <= tx) & (tx < hi[:, 0]) & (lo[:, 1] <= ty) & (ty < hi[:, 1])
    before = int(np.where(seen > 0, (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1]), 0).sum()) \
        - int(cover.sum())
    full = render_fn(arrays)
    sub = render_fn(tuple(a[cover] for a in arrays))
    ys, xs = slice(ty * 16, ty * 16 + 16), slice(tx * 16, tx * 16 + 16)
    err = max(float(np.abs(np.asarray(full[k])[..., ys, xs] - np.asarray(sub[k])[..., ys, xs])
                    .max()) for k in OUTPUTS)
    return err, int(cover.sum()), before


def test_tile_independence_float64_sums():
    """A late tile's pixels do not depend on the entries of the tiles
    before it: the full render equals the render of the Gaussians covering
    it within 1e-5. The JAX function's float32 running sums over the whole
    buffer lose the late tile's values behind ~1800 opaque entries (its
    error is above the bar, recorded in ROADMAP.md section C)."""
    cam = camera_np(48, 64)
    arrays = tile_scene()
    ts, js = torch_settings(cam, 0), jax_settings(cam, 0)
    err, n_cover, before = late_tile_error(
        lambda a: t2.render_tiled_2dgs(*torch_args(a), ts), arrays, cam, 3)
    assert n_cover >= 8 and before > 1000
    assert err <= 1e-5, err
    j_err, _, _ = late_tile_error(lambda a: j_render(a, js), arrays, cam, 3)
    print(f"late tile after {before} entries: port {err:.3e}, JAX {j_err:.3e}")
    assert j_err > 1e-5, j_err


# ------------------------------------------------------ the model classes
def test_2dgs_model_renders_surfels_and_launches_no_compositor():
    from reduced_3dgs_torch.models import CameraTrainableGaussianModel
    from reduced_3dgs_torch.shculling import (CameraTrainableVariableSHGsplat2DGSGaussianModel,
                                              VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_tpu.shculling import VariableSHGsplat2DGSGaussianModel as JModel
    from reduced_3dgs_tpu.dataset import build_camera as j_build_camera

    assert issubclass(CameraTrainableVariableSHGsplat2DGSGaussianModel,
                      VariableSHGsplat2DGSGaussianModel)
    assert issubclass(CameraTrainableVariableSHGsplat2DGSGaussianModel,
                      CameraTrainableGaussianModel)
    params, degrees = random_cloud_np(7, 40, scale_lo=-3.0, scale_hi=-2.0)
    model = VariableSHGsplat2DGSGaussianModel(3, device="cpu").load_numpy(params, degrees)
    cam = build_camera(32, 40, 1.0, 0.8, device="cpu")
    before = {f: getattr(composite, f).launches
              for f in ("composite_fwd", "composite_fwd_stats", "composite_bwd")}
    out = model(cam)
    stats = model(cam, with_stats=True)
    out["render"].sum().backward()
    assert {f: getattr(composite, f).launches for f in before} == before
    assert set(OUTPUTS) <= set(out) and "gaussians_count" in stats
    assert float(model._xyz.grad.abs().sum()) > 0
    dense = VariableSHGaussianModel(3, device="cpu").load_numpy(params, degrees)(cam)
    assert "normal" not in dense
    jm = JModel(3)
    jm.set_parameters({k: jnp.asarray(v) for k, v in params.items()})
    jm.aux_set({"degrees": jnp.asarray(degrees)})
    jout = jm(j_build_camera(image_height=32, image_width=40, FoVx=1.0, FoVy=0.8))
    for key in OUTPUTS:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]), rtol=0,
                                   atol=ATOL[key], err_msg=key)


def test_2dgs_camera_gradient_matches_jax():
    """One camera-trainer step on view 1 over a Trainer with depth
    supervision: the JAX slots (a random delta and Adam state) are carried
    across, and the loss and the camera gradient compared. The photometric
    term reaches the camera through M, the centres and the SH directions,
    the depth term through md as well."""
    from reduced_3dgs_torch.ops.rasterize import common
    from reduced_3dgs_torch.shculling import CameraTrainableVariableSHGsplat2DGSGaussianModel
    from reduced_3dgs_torch.trainer import Trainer as TTrainer
    from reduced_3dgs_torch.trainer import camera_trainer as tcam
    from reduced_3dgs_torch.trainer import extensions as text
    from reduced_3dgs_tpu.shculling import \
        CameraTrainableVariableSHGsplat2DGSGaussianModel as JModel
    from reduced_3dgs_tpu.trainer import Trainer as JTrainer
    from reduced_3dgs_tpu.trainer import camera_trainer as jcam
    from reduced_3dgs_tpu.trainer import extensions as jext

    from .test_torch_camera_trainer import (GRAD_ATOL, GRAD_RTOL, _capture, _jax_slots,
                                            random_delta)
    from .test_torch_densification import toy_scene
    from .test_torch_fixtures import jax_dataset, torch_dataset

    params, degrees, cams, images, depths = toy_scene(with_depth=True)
    params["scaling"][:, :2] += 1.5                       # surfels of a few pixels
    params["scaling"][:, 2] = -10.0
    jds, tds = jax_dataset(cams, images, depths), torch_dataset(cams, images, depths)
    jm = JModel(3)
    jm.set_parameters({k: jnp.asarray(v) for k, v in params.items()})
    jm.aux_set({"degrees": jnp.asarray(degrees)})
    tm = CameraTrainableVariableSHGsplat2DGSGaussianModel(3, device="cpu").load_numpy(
        params, degrees)

    def j_base(model, dataset):
        return jext.DepthTrainerWrapper(JTrainer, model, dataset)

    def t_base(model, dataset):
        return text.DepthTrainerWrapper(TTrainer, model, dataset)

    jtr = jcam.CameraTrainerWrapper(j_base, jm, jds)
    ttr = tcam.CameraTrainerWrapper(t_base, tm, tds)
    view = jds[1]
    delta = random_delta(np.random.default_rng(311))
    jtr._slot(view)
    jtr._cam_params[id(view)] = {k: jnp.asarray(v) for k, v in delta.items()}
    jtr._cam_adam[id(view)] = jtr._cam_adam[id(view)]._replace(
        count=jnp.int32(3), m={k: jnp.asarray(0.01 * v) for k, v in delta.items()},
        v={k: jnp.asarray(1e-4 * v * v) for k, v in delta.items()})
    ttr.load_numpy(*_jax_slots(jtr, jds))

    # The decisions of the render and of the depth term at the adjusted camera.
    with torch.no_grad():
        cam = ttr.adjusted_camera(tds[1])
        settings = tm.render_settings(cam)
        pre = t2.preprocess_2dgs(*tm.render_array_args(), settings)
        tiles_x, tiles_y = common.tile_grid(settings)
        ent = bin_and_sort(pre["rect_min"], pre["rect_max"], pre["tiles_touched"],
                           pre["depths"], tiles_x, tiles_y)
        assert_render_margins(pre, ent, tiles_x)
        assert float(pre["normal_view"][:, 2].abs().min()) > 1e-4
        out = tm(cam)
    alpha = (1 - out["final_T"]).double().numpy()
    assert_decision_margin(alpha, 0.5)
    gt = depths[1].astype(np.float64)
    used = (gt > 0) & (alpha > 0.5)
    assert used.sum() > 20
    depth = out["depth"].double().numpy() / np.maximum(alpha, 1e-6)
    assert (np.abs(depth - gt)[used] > 1e-5).all()

    j_grads, t_grads = [], []
    _capture(jtr, j_grads)
    _capture(ttr, t_grads)
    j_loss = float(jtr.step(view)[0])
    t_loss = float(ttr.step(tds[1])[0])
    assert t_loss == pytest.approx(j_loss, rel=1e-5)
    (jg,), (tg,) = j_grads, t_grads
    g = np.concatenate([jg["rot"], jg["trans"]])
    assert np.abs(jg["trans"]).max() > 1e-3 * np.abs(g).max()
    for k in ("rot", "trans"):
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max(), err_msg=k)
