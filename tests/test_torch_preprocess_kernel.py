"""The preprocess as one autograd Function over two CUDA kernels
(``ops/rasterize/preprocess_kernel.py``, ``csrc/preprocess.cu``).

On the CPU: ``common.preprocess`` takes the plain path and is bit for bit
``preprocess_plain``, whose float fields are the rows of its field matrix
in the compositor's order; the backward kernel's closed-form gradients,
written out here in PyTorch (``_bwd_formulas``), equal autograd through the
plain preprocess at every SH degree, with given colours, the NDC offset and
camera matrices that require grad, on a scene with rows behind the near
plane, rows whose determinant is exactly 0, colours at exactly 0 and points
on the FoV clamp; the wrappers' argument checks and the launch counters. On the card (marker ``cuda``): the kernels
against the plain version at chip_smoke's bench scene and at a random
1,250,000-Gaussian scene, a captured and replayed call against an eager one,
and the launch counters. Run there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_preprocess_kernel.py

(``--noconftest`` because the suite's conftest imports JAX, which this file
does not).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch import config  # noqa: E402
from reduced_3dgs_torch.ops import projection as proj  # noqa: E402
from reduced_3dgs_torch.ops import sh as sh_ops  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import common, composite, launches  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import preprocess_kernel as pk  # noqa: E402
from reduced_3dgs_torch.utils import profiling  # noqa: E402

from .test_torch_fixtures import (activated_np, camera_np, random_cloud_np,  # noqa: E402
                                  rotation_y, torch_settings)

GRAD_NAMES = ("means3d", "opacities_raw", "scales", "rotations", "shs", "mean2d_offset_ndc",
              "colors_precomp", "viewmatrix", "projmatrix", "campos")
INT_FIELDS = ("radii", "rect_min", "rect_max", "tiles_touched")


def _scene(n=300, seed=12, height=48, width=80):
    params, _ = random_cloud_np(seed, n, spread=2.5, z_spread=2.6)
    cam = camera_np(height, width, fovx=math.radians(70), R=rotation_y(0.35),
                    T=(0.3, -0.2, 0.4))
    return [torch.tensor(a) for a in activated_np(params)], cam


def _edge_scene():
    """Six Gaussians under the identity camera (view space = world space),
    one edge each: a needle whose 2D determinant rounds to exactly 0, the
    same needle shorter, points at +/- the FoV clamp exactly (u = t_x / t_z
    = 1.3 tan(fovx / 2)), a point behind the near plane, a point past the
    clamp. Every SH coefficient is 0 but the DC's, which makes the red and
    blue colours exactly 0 before the clamp."""
    cam = camera_np(48, 80, fovx=math.radians(70))
    lim = float(np.float32(1.3 * math.tan(cam["fovx"] / 2)))
    means = torch.tensor([[0.1, 0.0, 3.0], [0.0, 0.1, 2.0], [2 * lim, 0.05, 2.0],
                          [-2 * lim, 0.05, 2.0], [0.3, 0.2, -1.0], [3.0, 0.0, 1.0]])
    scales = torch.tensor([[1e6, 1e-3, 1e-3], [1e5, 1e-3, 1e-3], [0.1, 0.2, 0.05],
                           [0.1, 0.1, 0.1], [0.1, 0.1, 0.1], [0.1, 0.1, 0.1]])
    c, s = math.cos(math.pi / 8), math.sin(math.pi / 8)
    rotations = torch.tensor([[c, 0, 0, s], [c, 0, 0, s]] + [[1.0, 0, 0, 0]] * 4)
    c0 = torch.tensor(sh_ops.SH_C0, dtype=torch.float32)
    k = torch.tensor(-0.5, dtype=torch.float32) / c0
    while c0 * k + 0.5 != 0:     # the DC coefficient whose colour is exactly 0
        k = torch.nextafter(k, torch.tensor(-1.0 if c0 * k + 0.5 > 0 else 1.0))
    shs = torch.zeros(6, 16, 3)
    shs[:, 0, :] = k
    shs[:, 0, 1] = 0.3
    opacity = torch.tensor([[0.0], [0.5], [1.0], [-1.0], [2.0], [0.0]])
    return [means, opacity, scales, rotations, shs], cam


def _settings(cam, degree, camera_grad):
    s = torch_settings(cam, sh_degree=degree)
    if camera_grad:
        s = s._replace(viewmatrix=s.viewmatrix.clone().requires_grad_(True),
                       projmatrix=s.projmatrix.clone().requires_grad_(True),
                       campos=s.campos.clone().requires_grad_(True))
    return s


def _leaves(arrays, precomp, offset, n, seed):
    g = torch.Generator().manual_seed(seed)
    device = arrays[0].device
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    off = torch.zeros(n, 2, device=device).requires_grad_(True) if offset else None
    colors = (torch.rand(n, 3, generator=g).to(device).requires_grad_(True) if precomp
              else None)
    return leaves, off, colors


def _grads_through(fn, arrays, settings, precomp, offset, camera_grad, g_fields):
    """Gradients of <g_fields, fields> through ``fn`` (the plain preprocess
    or the Function) with respect to every input, None where it has none."""
    n = arrays[0].shape[0]
    leaves, off, colors = _leaves(arrays, precomp, offset, n, 5)
    s = settings
    if camera_grad:
        s = s._replace(viewmatrix=s.viewmatrix.detach().clone().requires_grad_(True),
                       projmatrix=s.projmatrix.detach().clone().requires_grad_(True),
                       campos=s.campos.detach().clone().requires_grad_(True))
    fields, out = fn(leaves, off, colors, s)
    inputs = leaves + [off, colors, s.viewmatrix, s.projmatrix, s.campos]
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad((fields * g_fields).sum(), wrt, allow_unused=True))
    grads = [next(got) if t is not None and t.requires_grad else None for t in inputs]
    return dict(zip(GRAD_NAMES, grads)), out


def _plain(leaves, off, colors, s):
    pre = common.preprocess_plain(*leaves, s, off, colors)
    return composite.pack_fields(pre), pre


def _plain_fwd(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
               colors_precomp, viewmatrix, projmatrix, campos, settings):
    """``pk.preprocess_fwd``'s outputs from the plain preprocess."""
    settings = settings._replace(viewmatrix=viewmatrix, projmatrix=projmatrix, campos=campos)
    with torch.no_grad():
        pre = common.preprocess_plain(means3d, opacities_raw, scales, rotations, shs, settings,
                                      mean2d_offset_ndc, colors_precomp)
    return pre.fields, pre.radii, pre.rect_min, pre.rect_max, pre.tiles_touched


class _Formulas(torch.autograd.Function):
    """``pk.Preprocess`` on the CPU: the plain forward, and the backward
    kernel's formulas as the backward."""

    @staticmethod
    def forward(ctx, means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
                colors_precomp, viewmatrix, projmatrix, campos, settings):
        out = _plain_fwd(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
                         colors_precomp, viewmatrix, projmatrix, campos, settings)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(means3d, opacities_raw, scales, rotations, shs, colors_precomp,
                              viewmatrix, projmatrix, campos)
        ctx.settings = settings
        return out

    @staticmethod
    def backward(ctx, g_fields, *_):
        return (*_bwd_formulas(g_fields, *ctx.saved_tensors, ctx.settings,
                               ctx.needs_input_grad[:10]), None)


def _function(leaves, off, colors, s):
    """The kernels' Function on the card, the formulas' on the CPU."""
    fn = pk.Preprocess if leaves[0].device.type == "cuda" else _Formulas
    out = fn.apply(*leaves, off, colors, s.viewmatrix, s.projmatrix, s.campos, s)
    return out[0], out


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _bwd_formulas(g_fields, means3d, opacities_raw, scales, rotations, shs, colors_precomp,
                  viewmatrix, projmatrix, campos, settings, needs):
    """``pk.preprocess_bwd`` in plain PyTorch: the backward kernel's
    closed-form gradients, line for line, over [N] columns."""
    H, W, _, _, fx, fy, lim_x, lim_y, modifier = pk._scalars(settings)
    degree = pk._degree(shs, colors_precomp, settings)
    V, P = viewmatrix.detach(), projmatrix.detach()
    m = means3d.detach().unbind(-1)
    gx, gy, gA, gB, gC, g_op, g_r, g_g, g_b, g_depth = g_fields

    def transform(M, k):
        return ((m[0] * M[0, k] + m[1] * M[1, k]) + m[2] * M[2, k]) + M[3, k]

    # Screen centre: px = ((ndc_x + 1) W - 1) / 2, ndc = h_xy / (h_w + 1e-7) + offset.
    h0, h1, h3 = transform(P, 0), transform(P, 1), transform(P, 3)
    pw = 1.0 / (h3 + 1e-7)
    d_ndc_x, d_ndc_y = gx * 0.5 * W, gy * 0.5 * H
    dh = [d_ndc_x * pw, d_ndc_y * pw, None, -(d_ndc_x * h0 + d_ndc_y * h1) * pw * pw]

    # View point t, the culled rows' z = 1 and the clamped Jacobian.
    t = [transform(V, k) for k in range(3)]
    visible = t[2] > config.NEAR_CULL_Z
    tz = torch.where(visible, t[2], torch.ones_like(t[2]))
    inv = 1.0 / tz
    u, v = t[0] / tz, t[1] / tz
    tx, ty = torch.clamp(u, -lim_x, lim_x) * tz, torch.clamp(v, -lim_y, lim_y) * tz
    j00, j02 = fx * inv, -fx * tx * inv * inv
    j11, j12 = fy * inv, -fy * ty * inv * inv
    T0 = [j00 * V[k, 0] + j02 * V[k, 2] for k in range(3)]
    T1 = [j11 * V[k, 1] + j12 * V[k, 2] for k in range(3)]

    # World covariance Sigma = RS RS^T, RS = R(q) diag(s * modifier).
    r, x, y, z = rotations.detach().unbind(-1)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    S = (scales.detach() * modifier).unbind(-1)
    RS = [[R[i][j] * S[j] for j in range(3)] for i in range(3)]
    Sig = [[_dot3(RS[i], RS[j]) for j in range(3)] for i in range(3)]
    ST0 = [_dot3(Sig[i], T0) for i in range(3)]
    ST1 = [_dot3(Sig[i], T1) for i in range(3)]
    a = _dot3(T0, ST0) + config.COV2D_LOWPASS
    b = _dot3(T0, ST1)
    c = _dot3(T1, ST1) + config.COV2D_LOWPASS

    # Conic (c, -b, a) / det, zero where det == 0.
    det = a * c - b * b
    nonzero = det != 0.0
    di = torch.where(nonzero, 1.0 / torch.where(nonzero, det, torch.ones_like(det)),
                     torch.zeros_like(det))
    d_det = -(gA * c - gB * b + gC * a) * di * di
    da = gC * di + d_det * c
    db = -gB * di - 2.0 * b * d_det
    dc = gA * di + d_det * a

    # Back through cov2d = (T0 Sig T0 + 0.3, T0 Sig T1, T1 Sig T1 + 0.3).
    dT0 = [2.0 * da * ST0[k] + db * ST1[k] for k in range(3)]
    dT1 = [db * ST0[k] + 2.0 * dc * ST1[k] for k in range(3)]
    dj00 = _dot3(dT0, [V[k, 0] for k in range(3)])
    dj02 = _dot3(dT0, [V[k, 2] for k in range(3)])
    dj11 = _dot3(dT1, [V[k, 1] for k in range(3)])
    dj12 = _dot3(dT1, [V[k, 2] for k in range(3)])
    d_tx = -fx * inv * inv * dj02
    d_ty = -fy * inv * inv * dj12
    d_inv = fx * dj00 + fy * dj11 - 2.0 * inv * (fx * tx * dj02 + fy * ty * dj12)
    in_x = (u >= -lim_x) & (u <= lim_x)
    in_y = (v >= -lim_y) & (v <= lim_y)
    du = torch.where(in_x, d_tx * tz, torch.zeros_like(d_tx))
    dv = torch.where(in_y, d_ty * tz, torch.zeros_like(d_ty))
    d_tz = (-d_inv * inv * inv + d_tx * torch.clamp(u, -lim_x, lim_x)
            + d_ty * torch.clamp(v, -lim_y, lim_y) - (du * t[0] + dv * t[1]) * inv * inv)
    dt = [du * inv, dv * inv, g_depth + torch.where(visible, d_tz, torch.zeros_like(d_tz))]

    # Sigma -> RS -> (R, S) -> (q, s): dRS = (dSig + dSig^T) RS.
    M = [[2.0 * da * T0[i] * T0[l] + db * (T0[i] * T1[l] + T1[i] * T0[l])
          + 2.0 * dc * T1[i] * T1[l] for l in range(3)] for i in range(3)]
    dRS = [[_dot3(M[i], [RS[l][j] for l in range(3)]) for j in range(3)] for i in range(3)]
    d_scales = torch.stack([_dot3([dRS[i][j] for i in range(3)], [R[i][j] for i in range(3)])
                            * modifier for j in range(3)], -1)
    dR = [[dRS[i][j] * S[j] for j in range(3)] for i in range(3)]
    d_rot = torch.stack([
        2.0 * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] - y * dR[2][0]
               + x * dR[2][1]),
        2.0 * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] - 2.0 * x * dR[1][1] - r * dR[1][2]
               + z * dR[2][0] + r * dR[2][1] - 2.0 * x * dR[2][2]),
        2.0 * (-2.0 * y * dR[0][0] + x * dR[0][1] + r * dR[0][2] + x * dR[1][0] + z * dR[1][2]
               - r * dR[2][0] + z * dR[2][1] - 2.0 * y * dR[2][2]),
        2.0 * (-2.0 * z * dR[0][0] - r * dR[0][1] + x * dR[0][2] + r * dR[1][0]
               - 2.0 * z * dR[1][1] + y * dR[1][2] + x * dR[2][0] + y * dR[2][1])], -1)

    # Colour: SH at the view direction, + 0.5, maximum(., 0) (1/2 at 0).
    d_shs = d_colors = None
    dm_rgb = torch.zeros_like(means3d)
    g_rgb = torch.stack([g_r, g_g, g_b], -1)
    if degree < 0:
        d_colors = g_rgb
    else:
        vec = means3d.detach() - campos.detach()
        sq = (vec * vec).sum(-1) + 1e-16
        rs = torch.rsqrt(sq)
        dirs = vec * rs[:, None]
        k = sh_ops.num_sh_coeffs(degree)
        basis = sh_ops.sh_basis(dirs, degree)                          # [N,k]
        coeffs = shs.detach()[:, :k]
        pre = (basis[..., None] * coeffs).sum(1) + 0.5
        d_pre = torch.where(pre > 0, g_rgb, torch.where(pre == 0, 0.5 * g_rgb,
                                                        torch.zeros_like(g_rgb)))
        d_shs = torch.zeros_like(shs)
        d_shs[:, :k] = basis[..., None] * d_pre[:, None, :]
        if degree > 0:
            d_basis = (coeffs * d_pre[:, None, :]).sum(-1)             # [N,k]
            d_dir = _sh_dir_grad(dirs, d_basis, degree)
            dm_rgb = rs[:, None] * d_dir - ((d_dir * vec).sum(-1) * rs * rs * rs)[:, None] * vec

    d_means = dm_rgb + torch.stack([
        sum(dh[c] * P[i, c] for c in (0, 1, 3)) + _dot3(dt, [V[i, c] for c in range(3)])
        for i in range(3)], -1)
    o = torch.sigmoid(opacities_raw.detach())
    d_opacity = g_op.reshape(o.shape) * o * (1.0 - o)

    grads = [d_means, d_opacity, d_scales, d_rot, d_shs,
             torch.stack([d_ndc_x, d_ndc_y], -1), d_colors, None, None, None]
    if any(needs[7:10]):
        dV = torch.zeros((4, 4, m[0].shape[0]), dtype=torch.float32)
        dP = torch.zeros_like(dV)
        for k in range(3):
            for i in range(3):
                dV[i, k] += dt[k] * m[i]
            dV[3, k] += dt[k]
            dV[k, 0] += dT0[k] * j00
            dV[k, 1] += dT1[k] * j11
            dV[k, 2] += dT0[k] * j02 + dT1[k] * j12
        for cc in (0, 1, 3):
            for i in range(3):
                dP[i, cc] += dh[cc] * m[i]
            dP[3, cc] += dh[cc]
        grads[7:10] = [dV.sum(-1), dP.sum(-1), -dm_rgb.sum(0) if degree > 0 else None]
    return tuple(g if need else None for g, need in zip(grads, needs))


def _sh_dir_grad(dirs, d_basis, degree):
    """The gradient of the unit direction [N,3] through ``sh_basis``."""
    x, y, z = dirs.unbind(-1)
    C1, C2, C3 = sh_ops.SH_C1, sh_ops.SH_C2, sh_ops.SH_C3
    db = d_basis.unbind(-1)
    gx = -C1 * db[3]
    gy = -C1 * db[1]
    gz = C1 * db[2]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + C2[0] * y * db[4] - 2.0 * C2[2] * x * db[6] + C2[3] * z * db[7] \
            + 2.0 * C2[4] * x * db[8]
        gy = gy + C2[0] * x * db[4] + C2[1] * z * db[5] - 2.0 * C2[2] * y * db[6] \
            - 2.0 * C2[4] * y * db[8]
        gz = gz + C2[1] * y * db[5] + 4.0 * C2[2] * z * db[6] + C2[3] * x * db[7]
        if degree > 2:
            gx = gx + (C3[0] * 6.0 * x * y * db[9] + C3[1] * y * z * db[10]
                       - C3[2] * 2.0 * x * y * db[11] - C3[3] * 6.0 * x * z * db[12]
                       + C3[4] * (4.0 * zz - 3.0 * xx - yy) * db[13]
                       + C3[5] * 2.0 * x * z * db[14] + C3[6] * 3.0 * (xx - yy) * db[15])
            gy = gy + (C3[0] * 3.0 * (xx - yy) * db[9] + C3[1] * x * z * db[10]
                       + C3[2] * (4.0 * zz - xx - 3.0 * yy) * db[11]
                       - C3[3] * 6.0 * y * z * db[12] - C3[4] * 2.0 * x * y * db[13]
                       - C3[5] * 2.0 * y * z * db[14] - C3[6] * 6.0 * x * y * db[15])
            gz = gz + (C3[1] * x * y * db[10] + C3[2] * 8.0 * y * z * db[11]
                       + C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * db[12]
                       + C3[4] * 8.0 * x * z * db[13] + C3[5] * (xx - yy) * db[14])
    return torch.stack([gx, gy, gz], -1)



# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("degree", [0, 3])
def test_cpu_preprocess_is_the_plain_version(degree):
    arrays, cam = _scene()
    s = torch_settings(cam, sh_degree=degree)
    launches = (pk.preprocess_fwd.launches, pk.preprocess_bwd.launches)
    got = common.preprocess(*arrays, s)
    want = common.preprocess_plain(*arrays, s)
    for name in common.PreprocessedGaussians._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (pk.preprocess_fwd.launches, pk.preprocess_bwd.launches) == launches


@pytest.mark.parametrize("scene", ["random", "edges"])
@pytest.mark.parametrize("degree, precomp", [(0, False), (1, False), (2, False), (3, False),
                                             (3, True)])
def test_function_forward_is_the_plain_forward(scene, degree, precomp):
    """The forward the kernel is held to: the plain preprocess's field
    matrix holds, in the compositor's row order, the pixel centre, the
    conic, the opacity, the colour and the depth, each as the projection and
    SH functions give it; its float fields are views of those rows, and its
    integer outputs int32."""
    arrays, cam = _scene() if scene == "random" else _edge_scene()
    means, opacities_raw, scales, rotations, shs = arrays
    n = means.shape[0]
    s = torch_settings(cam, sh_degree=degree)
    off = torch.full((n, 2), 1e-3)
    colors = torch.rand(n, 3, generator=torch.Generator().manual_seed(1)) if precomp else None
    pre = common.preprocess_plain(*arrays, s, off, colors)
    H, W = s.image_height, s.image_width
    fx, fy = proj.focals_from_fov(W, H, s.tanfovx, s.tanfovy)
    depth = proj.world_to_view(means, s.viewmatrix)[..., 2]
    ndc = proj.project_points(means, s.projmatrix)[..., :2] + off
    cov2d = proj.build_cov2d(means, proj.build_cov3d(scales, s.scale_modifier, rotations),
                             s.viewmatrix, fx, fy, s.tanfovx, s.tanfovy,
                             valid=depth > config.NEAR_CULL_Z)
    rgb = colors if precomp else sh_ops.eval_sh(
        shs, sh_ops.normalize_dirs(means - s.campos), degree, clamp=True)
    rows = [proj.ndc2pix(ndc[:, 0], W), proj.ndc2pix(ndc[:, 1], H),
            *proj.invert_cov2d(cov2d)[0].unbind(-1), torch.sigmoid(opacities_raw.reshape(-1)),
            *rgb.unbind(-1), depth]
    assert pre.fields.shape == (composite.N_FIELDS, n)
    for i, want in enumerate(rows):
        assert torch.equal(pre.fields[i], want), i
    for name in ("depths", "means2d", "conic", "opacity", "rgb"):
        field = getattr(pre, name)
        assert field.untyped_storage().data_ptr() == pre.fields.untyped_storage().data_ptr()
    for name in INT_FIELDS:
        assert getattr(pre, name).dtype == torch.int32, name


@pytest.mark.parametrize("scene", ["random", "edges"])
@pytest.mark.parametrize("degree, precomp, offset, camera_grad", [
    (0, False, False, False), (1, False, True, False), (2, False, False, True),
    (3, False, True, False), (3, False, True, True), (3, True, True, True),
    (1, True, False, True), (0, False, True, True)])
def test_function_backward_is_autograd_of_the_plain_version(scene, degree, precomp, offset,
                                                            camera_grad):
    arrays, cam = _scene() if scene == "random" else _edge_scene()
    n = arrays[0].shape[0]
    s = _settings(cam, degree, camera_grad)
    g_fields = torch.randn(10, n, generator=torch.Generator().manual_seed(degree))
    want, pre = _grads_through(_plain, arrays, s, precomp, offset, camera_grad, g_fields)
    got, _ = _grads_through(_function, arrays, s, precomp, offset, camera_grad, g_fields)
    for name in GRAD_NAMES:
        if want[name] is None:
            assert got[name] is None, name
            continue
        assert got[name].shape == want[name].shape, name
        err = (got[name] - want[name]).norm() / want[name].norm().clamp_min(1e-30)
        assert err <= 1e-5, (name, float(err))
        if scene == "edges" and name not in ("viewmatrix", "projmatrix", "campos"):
            torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6,
                                       msg=name)
    if scene == "edges":
        # The edges are there: a zero determinant (zero conic), culled rows,
        # colours at exactly 0 before the clamp, centres on the FoV clamp.
        conic = pre.conic
        assert bool((conic[1] == 0).all()) and bool((pre.radii[[1, 4]] == 0).all())
        assert pre.depths[4] < 0.2
        if not precomp:
            assert bool((pre.rgb[:, [0, 2]] == 0).all())


def test_edge_scene_takes_each_convention():
    """At the edges the gradients follow the plain autograd's choices: the
    zero-determinant row's conic passes nothing back, the colour at exactly 0
    passes half its gradient to the SH, and the clamp passes its gradient at
    the limit (the row at the limit moves its means' x; the row past it does
    not, through the Jacobian)."""
    arrays, cam = _edge_scene()
    s = torch_settings(cam, sh_degree=3)
    g = torch.zeros(10, 6)
    g[6] = 1.0                                      # red only
    got, _ = _grads_through(_function, arrays, s, False, False, False, g)
    basis0 = torch.tensor(sh_ops.SH_C0, dtype=torch.float32)
    torch.testing.assert_close(got["shs"][:, 0, 0], torch.full((6,), 0.5) * basis0)
    g = torch.zeros(10, 6)
    g[2:5] = 1.0                                    # the conic only
    got, _ = _grads_through(_function, arrays, s, False, False, False, g)
    assert bool((got["scales"][1] == 0).all()) and bool((got["means3d"][1] == 0).all())
    assert bool((got["means3d"][2:4, 0] != 0).all())
    assert got["means3d"][5, 0] == 0


def _bad_args():
    arrays, cam = _scene(n=8)
    s = torch_settings(cam, sh_degree=3)
    return list(arrays) + [None, None, s.viewmatrix, s.projmatrix, s.campos, s]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "shs_coeffs", "device"])
def test_wrapper_checks_its_arguments(case):
    args = _bad_args()
    if case == "dtype":
        args[0] = args[0].double()
        match = "means3d must be float32"
    elif case == "shape":
        args[2] = args[2][:, :2].contiguous()
        match = "scales must be float32"
    elif case == "contiguity":
        args[3] = args[3].T.contiguous().T
        match = "rotations must be contiguous"
    elif case == "shs_coeffs":
        args[4] = args[4][:, :4].contiguous()
        match = "shs must be"
    else:
        match = "runs on cuda tensors"
        with pytest.raises(ValueError, match=match):
            pk.Preprocess.apply(*args)
    with pytest.raises(ValueError, match=match):
        pk.preprocess_fwd(*args)
    g = torch.zeros(10, 8)
    bwd_args = args[:5] + args[6:]
    needs = (True,) * 5 + (False,) * 5
    with pytest.raises(ValueError, match=match):
        pk.preprocess_bwd(g, *bwd_args, needs)
    with pytest.raises(ValueError, match="g_fields must be"):
        pk.preprocess_bwd(torch.zeros(9, 8), *_bad_args()[:5], *_bad_args()[6:], needs)


def test_launch_counters_are_in_the_tallies():
    out = profiling.counters()
    assert {"preprocess_kernel.preprocess_fwd.launches",
            "preprocess_kernel.preprocess_bwd.launches",
            "composite.composite_fwd.launches"} <= set(out)
    assert {"preprocess_fwd", "preprocess_bwd", "composite_fwd"} <= set(launches.captured_launches)
    before = pk.preprocess_fwd.launches, pk.preprocess_bwd.launches
    launches.add_replayed_launches({"preprocess_fwd": 2, "preprocess_bwd": 1})
    assert (pk.preprocess_fwd.launches, pk.preprocess_bwd.launches) == (before[0] + 2,
                                                                        before[1] + 1)
    pk.preprocess_fwd.launches, pk.preprocess_bwd.launches = before


def test_pack_fields_takes_the_kernels_matrix():
    arrays, cam = _scene(n=16)
    pre = common.preprocess_plain(*arrays, torch_settings(cam))
    assert composite.pack_fields(pre) is pre.fields
    fields = pre.fields.clone()
    assert composite.pack_fields(pre._replace(fields=fields)) is fields


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_scene(which, device):
    """(arrays, settings) on the card: chip_smoke's bench scene at its view
    0, or 1,250,000 random Gaussians at 979x546 around a turned camera."""
    if which == "bench":
        import chip_smoke as cs
        from reduced_3dgs_torch.shculling import VariableSHGaussianModel
        model = VariableSHGaussianModel(3, device=device).load_numpy(cs.bench_scene(0))
        camera = cs.view_camera(cs.view_poses()[0], device)
        return [a.detach().contiguous() for a in model.render_array_args()], \
            model.render_settings(camera)
    params, _ = random_cloud_np(18, 1_250_000, spread=3.0, z_spread=3.5, scale_lo=-5.0,
                                scale_hi=-1.5)
    cam = camera_np(546, 979, fovx=math.radians(70), R=rotation_y(0.2), T=(0.1, -0.1, 0.3))
    s = torch_settings(cam, sh_degree=3)
    s = s._replace(bg=s.bg.to(device), viewmatrix=s.viewmatrix.to(device),
                   projmatrix=s.projmatrix.to(device), campos=s.campos.to(device))
    return [torch.tensor(a, device=device) for a in activated_np(params)], s


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["bench", "random"])
def test_card_forward_against_plain(card, which):
    arrays, s = _card_scene(which, card)
    n = arrays[0].shape[0]
    off = torch.full((n, 2), 1e-4, device=card)
    with torch.no_grad():
        got = pk.preprocess_fwd(*arrays, off, None, s.viewmatrix, s.projmatrix, s.campos, s)
        want = _plain_fwd(*arrays, off, None, s.viewmatrix, s.projmatrix, s.campos, s)
    torch.cuda.synchronize()
    ok = torch.isclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    assert bool(ok.all()), f"{int((~ok).sum())} field values off, rows {(~ok).nonzero()[:5]}"
    for name, a, b in zip(INT_FIELDS, got[1:], want[1:]):
        rows = (a != b).reshape(n, -1).any(-1)
        assert int(rows.sum()) <= 1e-5 * n, (name, int(rows.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("which, camera_grad", [("bench", True), ("random", False),
                                                ("random", True)])
def test_card_backward_against_autograd(card, which, camera_grad):
    arrays, s = _card_scene(which, card)
    n = arrays[0].shape[0]
    gen = torch.Generator(device=card).manual_seed(3)
    g_fields = torch.randn(10, n, device=card, generator=gen)
    want, _ = _grads_through(_plain, arrays, s, False, True, camera_grad, g_fields)
    got, _ = _grads_through(_function, arrays, s, False, True, camera_grad, g_fields)
    for name in GRAD_NAMES:
        if want[name] is None:
            assert got[name] is None, name
            continue
        err = float((got[name] - want[name]).norm() / want[name].norm().clamp_min(1e-30))
        bar = 1e-3 if name in ("viewmatrix", "projmatrix", "campos") else 1e-4
        assert err <= bar, (name, err)


@pytest.mark.cuda
def test_card_captured_call_equals_eager_and_counts(card):
    arrays, s = _card_scene("bench", card)
    n = arrays[0].shape[0]
    off = torch.zeros(n, 2, device=card)
    g_fields = torch.randn(10, n, device=card)
    needs = (True,) * 6 + (False,) + (True,) * 3

    def call():
        out = pk.preprocess_fwd(*arrays, off, None, s.viewmatrix, s.projmatrix, s.campos, s)
        grads = pk.preprocess_bwd(g_fields, *arrays, None, s.viewmatrix, s.projmatrix,
                                  s.campos, s, needs)
        return out, grads

    before = pk.preprocess_fwd.launches, pk.preprocess_bwd.launches
    eager = call()
    assert (pk.preprocess_fwd.launches, pk.preprocess_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    captured = dict(launches.captured_launches)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    assert launches.captured_launches["preprocess_fwd"] == captured["preprocess_fwd"] + 1
    assert launches.captured_launches["preprocess_bwd"] == captured["preprocess_bwd"] + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager[0] + eager[1], replayed[0] + replayed[1]):
        if a is not None:
            assert torch.equal(a, b)
