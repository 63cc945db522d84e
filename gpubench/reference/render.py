"""Plain 3D Gaussian Splatting renderer: the benchmark's reference.

It follows the semantics of the original CUDA rasterizer (Kerbl et al.,
"3D Gaussian Splatting for Real-Time Radiance Field Rendering", 2023) as
the configuration states them, in plain PyTorch, and imports nothing of the
program under test:

  * a Gaussian is culled at view depth <= 0.2; its 2D covariance is the EWA
    projection with the view point clamped to 1.3 tan(fov / 2) and 0.3 px
    added to the diagonal; its radius is ceil(3 sqrt(lambda_max));
  * it is binned to the 16 x 16 tiles that the box of its alpha contour
    (op * G = 1/255, never wider than the 3-sigma radius) touches;
  * colour is the SH expansion at its own degree, + 0.5, clamped at 0;
  * per pixel, entries go front to back by view depth; alpha = min(0.99,
    op e^power); an entry with power > 0 or alpha < 1/255 is skipped; the
    first entry with T (1 - alpha) < 1e-4 ends the pixel and neither it nor
    any later entry contributes.

The compositor is written for clarity and for memory, not speed: tiles are
laid out as padded rows of their depth-sorted entries, grouped by length,
and each group is composited for all 256 pixels at once, the transmittance
being an exclusive cumulative product. Gradients come from autograd through
a recomputation of each group (``render_backward``), so no group's
temporaries outlive it.

Matrices use the row-vector storage of 3DGS: p_view = [p, 1] @ world_view.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

BLOCK = 16
PIXELS = BLOCK * BLOCK
NEAR_Z = 0.2
LOWPASS = 0.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
# (pixel, entry) pairs composited at once: bounds each group's temporaries.
PAIRS_PER_GROUP = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclass
class View:
    """A pinhole view: image size, field of view, and its matrices."""
    height: int
    width: int
    fovx: float
    fovy: float
    world_view: torch.Tensor    # [4,4] row-vector storage
    full_proj: torch.Tensor     # [4,4] row-vector storage
    campos: torch.Tensor        # [3]
    bg: torch.Tensor            # [3]
    proj: torch.Tensor          # [4,4] row-vector storage

    @property
    def tiles(self):
        return -(-self.width // BLOCK), -(-self.height // BLOCK)


def projection_matrix(fovx: float, fovy: float, znear: float = 0.01, zfar: float = 100.0,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    """The 3DGS perspective matrix in row-vector storage."""
    top = math.tan(fovy * 0.5) * znear
    right = math.tan(fovx * 0.5) * znear
    P = torch.zeros((4, 4), dtype=dtype, device=device)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.T.contiguous()


def make_view(rot_w2c, t_w2c, height: int, width: int, fovx: float, fovy: float,
              bg=(0.0, 0.0, 0.0), device=None, dtype=torch.float32) -> View:
    """The view of a camera whose world-to-view map is p -> rot_w2c p + t_w2c
    (column vectors; numpy or tensors)."""
    rot = torch.as_tensor(np.asarray(rot_w2c, np.float32), device=device)
    t = torch.as_tensor(np.asarray(t_w2c, np.float32), device=device)
    wv = torch.zeros((4, 4), dtype=torch.float32, device=device)
    wv[:3, :3] = rot.T
    wv[3, :3] = t
    wv[3, 3] = 1.0
    return view_from_world_view(wv, height, width, fovx, fovy, bg, dtype)


def view_from_world_view(wv: torch.Tensor, height, width, fovx, fovy, bg=(0.0, 0.0, 0.0),
                         dtype=torch.float32, proj: Optional[torch.Tensor] = None) -> View:
    """A view from its world_view matrix (differentiable in it)."""
    device = wv.device
    proj = projection_matrix(fovx, fovy, device=device) if proj is None else proj
    wv = wv.to(dtype)
    proj = proj.to(dtype)
    campos = torch.linalg.inv(wv.float()).to(dtype)[3, :3]
    return View(int(height), int(width), float(fovx), float(fovy), wv, wv @ proj, campos,
                torch.as_tensor(bg, dtype=dtype, device=device), proj)


def orbit_pose(yaw: float, pitch: float, radius: float, target, height: int, width: int,
               fovy: float = math.radians(50)):
    """(rot_w2c, t_w2c, fovx, fovy) of a camera on an orbit of ``target``
    whose world up is -y (the COLMAP convention), in float64 numpy."""
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    target = np.asarray(target, np.float64)
    C = target + radius * np.array([sy * cp, -sp, -cy * cp])
    f = (target - C) / np.linalg.norm(target - C)
    r = np.cross(np.array([0.0, 1.0, 0.0]), f)
    if np.linalg.norm(r) < 1e-6:
        r = np.array([1.0, 0.0, 0.0])
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    M = np.stack([r, u, f])
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    return M, -M @ C, fovx, fovy


# ----------------------------------------------------------------- preprocess
def _transform(xyz, m):
    """[p, 1] @ m, summed term by term in this order: the near cull at
    depth 0.2 decides on the last bit of the depth, and a large splat just
    past the near plane can cover much of the image, so the depth is formed
    by the rounding the 3DGS kernels use for it."""
    return xyz[:, 0:1] * m[0] + xyz[:, 1:2] * m[1] + xyz[:, 2:3] * m[2] + m[3]


def _quat_rot(q):
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _sh_rgb(dc, rest, degrees, dirs):
    """SH colour at each Gaussian's own degree (rest coefficients past it
    are masked to zero), + 0.5, clamped at 0 by a maximum."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    basis = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
             SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    basis = torch.stack(basis, -1)                                   # [N,15]
    used = torch.arange(15, device=dc.device) < ((degrees.long() + 1) ** 2 - 1)[:, None]
    rest = rest * used[..., None].to(rest.dtype)
    rgb = SH_C0 * dc[:, 0] + torch.sum(basis[..., None] * rest, dim=1) + 0.5
    return torch.maximum(rgb, torch.zeros_like(rgb))


def preprocess(params: dict, degrees: torch.Tensor, view: View,
               offset: Optional[torch.Tensor] = None, dtype=torch.float32) -> dict:
    """Per-Gaussian screen quantities. ``params`` are the raw parameters
    (xyz, features_dc, features_rest, scaling as logs, rotation unnormalised,
    opacity as logits); ``offset`` [N,2] is added to the NDC centre (its
    gradient is the screen-space gradient that densification accumulates).
    Returns the fields [N,10] (x, y, conic A, B, C, opacity, r, g, b, depth)
    and, not differentiable, the tile rects, ``visible`` and ``radii``."""
    p = {k: v.to(dtype) for k, v in params.items()}
    xyz = p["xyz"]
    W_, H_ = view.width, view.height
    tiles_x, tiles_y = view.tiles
    tanx, tany = math.tan(view.fovx * 0.5), math.tan(view.fovy * 0.5)
    fx, fy = W_ / (2 * tanx), H_ / (2 * tany)
    wv, fp = view.world_view.to(dtype), view.full_proj.to(dtype)
    t = _transform(xyz, wv)[:, :3]
    depth = t[:, 2]
    visible = depth > NEAR_Z
    hom = _transform(xyz, fp)
    ndc = hom[:, :2] * (1.0 / (hom[:, 3:4] + 1e-7))
    if offset is not None:
        ndc = ndc + offset.to(dtype)
    q = p["rotation"] * torch.rsqrt(torch.sum(p["rotation"] ** 2, -1, keepdim=True) + 1e-24)
    RS = _quat_rot(q) * torch.exp(p["scaling"])[:, None, :]
    cov3 = RS @ RS.transpose(1, 2)
    tz = torch.where(visible, depth, torch.ones_like(depth))
    tx = torch.clamp(t[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(t[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz
    zeros = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zeros, -fx * tx / (tz * tz)], -1),
                     torch.stack([zeros, fy / tz, -fy * ty / (tz * tz)], -1)], -2)  # [N,2,3]
    JW = J @ wv[:3, :3].T
    cov2 = JW @ cov3 @ JW.transpose(1, 2)
    a = cov2[:, 0, 0] + LOWPASS
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + LOWPASS
    det = a * c - b * b
    nonzero = det != 0
    det_inv = torch.where(nonzero, 1.0 / torch.where(nonzero, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    visible = visible & nonzero
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    px = ((ndc[:, 0] + 1.0) * W_ - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * H_ - 1.0) * 0.5
    op = torch.sigmoid(p["opacity"][:, 0])
    dirs = xyz - view.campos.to(dtype)
    dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-16)
    rgb = _sh_rgb(p["features_dc"], p["features_rest"], degrees, dirs)
    fields = torch.stack([px, py, c * det_inv, -b * det_inv, a * det_inv, op,
                          rgb[:, 0], rgb[:, 1], rgb[:, 2], depth], -1)
    with torch.no_grad():
        pix = torch.stack([px, py], -1).float()
        rad = radius.float()

        def rect(half):
            lo = torch.trunc((pix - half) / BLOCK)
            hi = torch.floor((pix + half) / BLOCK) + 1
            lim = torch.tensor([tiles_x, tiles_y], dtype=lo.dtype, device=lo.device)
            return (torch.minimum(torch.clamp(lo, min=0), lim).long(),
                    torch.minimum(torch.clamp(hi, min=0), lim).long())

        lo3, hi3 = rect(rad[:, None])
        wh3 = torch.clamp(hi3 - lo3, min=0)
        visible = visible & (wh3[:, 0] * wh3[:, 1] > 0)
        t2 = torch.clamp(2.0 * torch.log(255.0 * torch.clamp(op.float(), min=1e-6)), min=0.0)
        half = torch.stack([torch.minimum(rad, torch.sqrt(t2 * torch.clamp(a.float(), min=0))),
                            torch.minimum(rad, torch.sqrt(t2 * torch.clamp(c.float(), min=0)))],
                           -1)
        lo, hi = rect(half)
        radii = torch.where(visible, radius.float(), torch.zeros_like(rad)).int()
    return {"fields": fields, "rect_lo": lo, "rect_hi": hi, "visible": visible,
            "radii": radii, "depth": depth.detach().float()}


# -------------------------------------------------------------------- binning
def bin_entries(pre: dict, view: View) -> dict:
    """The (tile, Gaussian) entries of the visible Gaussians' rects, sorted
    by tile and then view depth (ties in emission order): ``gidx`` [E] and
    ``tile`` [E], and each tile's [start, end) in them."""
    lo, hi, vis = pre["rect_lo"], pre["rect_hi"], pre["visible"]
    tiles_x, tiles_y = view.tiles
    device = lo.device
    w = torch.clamp(hi[:, 0] - lo[:, 0], min=0)
    h = torch.clamp(hi[:, 1] - lo[:, 1], min=0)
    counts = torch.where(vis, w * h, torch.zeros_like(w))
    total = int(counts.sum())
    gidx = torch.repeat_interleave(torch.arange(counts.numel(), device=device), counts,
                                   output_size=total)
    first = torch.cumsum(counts, 0) - counts
    ordinal = torch.arange(total, device=device) - first[gidx]
    width = torch.clamp(w, min=1)[gidx]
    tile = (lo[gidx, 1] + ordinal // width) * tiles_x + lo[gidx, 0] + ordinal % width
    depth_bits = pre["depth"].contiguous().view(torch.int32)[gidx].long()
    _, order = torch.sort((tile << 32) | depth_bits, stable=True)
    tile, gidx = tile[order], gidx[order]
    tiles = torch.arange(tiles_x * tiles_y, device=device)
    return {"gidx": gidx, "tile": tile,
            "start": torch.searchsorted(tile, tiles), "end": torch.searchsorted(tile, tiles,
                                                                               right=True)}


def tile_groups(bins: dict):
    """Tiles with entries, longest first, cut into groups whose padded
    (pixel, entry) pairs stay within ``PAIRS_PER_GROUP``: a list of (tile
    ids, their length L, the [b, L] entry positions, padded with -1)."""
    start, end = bins["start"], bins["end"]
    lengths = (end - start).cpu()
    order = torch.argsort(lengths, descending=True)
    order = order[lengths[order] > 0]
    groups, i = [], 0
    while i < order.numel():
        L = int(lengths[order[i]])
        b = max(1, PAIRS_PER_GROUP // (PIXELS * L))
        tiles = order[i:i + b].to(start.device)
        pos = start[tiles][:, None] + torch.arange(L, device=start.device)
        pos = torch.where(pos < end[tiles][:, None], pos, torch.full_like(pos, -1))
        groups.append((tiles, L, pos))
        i += b
    return groups


def _pixels(tiles, tiles_x, dtype):
    p = torch.arange(PIXELS, device=tiles.device)
    x = (tiles % tiles_x * BLOCK)[:, None] + p % BLOCK
    y = (tiles // tiles_x * BLOCK)[:, None] + p // BLOCK
    return x.to(dtype), y.to(dtype)                                   # [b,256]


def composite_group(f: torch.Tensor, valid: torch.Tensor, px, py, counts: bool = False):
    """Composite one group: ``f`` [b, L, 10] entry fields, ``valid`` [b, L],
    pixel coordinates [b, 256]. Returns colour and depth [b,256,4] and the
    final transmittance [b,256]; with ``counts`` also the (pixel, entry)
    pairs scanned (each pixel's entries up to and including the one that
    ends it) and those that contribute."""
    x, y, A, B, C, op = (f[..., i][:, None, :] for i in range(6))
    dx = x - px[..., None]
    dy = y - py[..., None]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    gate = power <= 0
    raw = op * torch.exp(torch.where(gate, power, torch.zeros_like(power)))
    alpha = torch.where(raw < ALPHA_MAX, raw, torch.full_like(raw, ALPHA_MAX))
    gate = gate & (alpha >= ALPHA_MIN) & valid[:, None, :]
    one_m = 1.0 - torch.where(gate, alpha, torch.zeros_like(alpha))
    prod = torch.cumprod(one_m, dim=-1)
    t_in = torch.cat([torch.ones_like(prod[..., :1]), prod[..., :-1]], dim=-1)
    trigger = gate & (t_in * one_m < T_MIN)
    hits = torch.cumsum(trigger.to(torch.int32), dim=-1)
    contrib = gate & (hits == 0)
    w = torch.where(contrib, (1.0 - one_m) * t_in, torch.zeros_like(t_in))
    color4 = w @ f[..., 6:10]                                         # [b,256,4]
    final_t = torch.prod(torch.where(contrib, one_m, torch.ones_like(one_m)), dim=-1)
    if not counts:
        return color4, final_t
    with torch.no_grad():
        # Entries before the one that ends the pixel, plus that one.
        scanned = (hits == 0).sum(-1) + (hits[..., -1] > 0).to(torch.int64)
        scanned = torch.minimum(scanned, valid.sum(-1)[:, None])
    return color4, final_t, int(scanned.sum()), int(contrib.sum())


def _group_fields(fields, bins, pos):
    g = bins["gidx"][torch.clamp(pos, min=0)]
    return fields[g], pos >= 0


def render_forward(fields: torch.Tensor, bins: dict, view: View, groups=None,
                   counts: bool = False) -> dict:
    """The image [3,H,W], final transmittance [H,W] and depth [H,W] of
    ``fields``' binned entries, without autograd. With ``counts``, also the
    (pixel, entry) pairs scanned and those that contribute, over the image's
    tiles (pixels past its edge included, as a tile covers them)."""
    tiles_x, tiles_y = view.tiles
    device, dtype = fields.device, fields.dtype
    groups = tile_groups(bins) if groups is None else groups
    n_tiles = tiles_x * tiles_y
    color4 = torch.zeros((n_tiles, PIXELS, 4), dtype=dtype, device=device)
    final_t = torch.ones((n_tiles, PIXELS), dtype=dtype, device=device)
    scanned = contributing = 0
    with torch.no_grad():
        for tiles, _, pos in groups:
            f, valid = _group_fields(fields, bins, pos)
            px, py = _pixels(tiles, tiles_x, dtype)
            res = composite_group(f, valid, px, py, counts)
            color4[tiles] = res[0]
            final_t[tiles] = res[1]
            if counts:
                scanned += res[2]
                contributing += res[3]
    out = _assemble(color4, final_t, view)
    if counts:
        out.update(scanned_pairs=scanned, contributing_pairs=contributing)
    return out


def _assemble(color4, final_t, view: View) -> dict:
    tiles_x, tiles_y = view.tiles

    def stitch(v):
        extra = v.shape[2:]
        v = v.reshape(tiles_y, tiles_x, BLOCK, BLOCK, *extra).movedim(2, 1)
        return v.reshape(tiles_y * BLOCK, tiles_x * BLOCK, *extra)[:view.height, :view.width]

    T = stitch(final_t)
    c4 = stitch(color4)
    image = c4[..., :3] + T[..., None] * view.bg
    return {"render": image.permute(2, 0, 1), "final_T": T, "depth": c4[..., 3]}


def render_backward(fields: torch.Tensor, bins: dict, view: View, g_image: torch.Tensor,
                    groups=None) -> torch.Tensor:
    """d<g_image, image>/d fields [N,10]: each group recomputed with autograd
    and differentiated alone (pixels are independent)."""
    tiles_x, tiles_y = view.tiles
    dtype = fields.dtype
    groups = tile_groups(bins) if groups is None else groups
    pad_h, pad_w = tiles_y * BLOCK, tiles_x * BLOCK
    g = torch.zeros((3, pad_h, pad_w), dtype=dtype, device=fields.device)
    g[:, :view.height, :view.width] = g_image.to(dtype)
    g_color = (g.reshape(3, tiles_y, BLOCK, tiles_x, BLOCK).permute(1, 3, 2, 4, 0)
               .reshape(tiles_y * tiles_x, PIXELS, 3))
    g_t = g_color @ view.bg.to(dtype)                                    # [T,256]
    grad = torch.zeros_like(fields)
    base = fields.detach()
    for tiles, _, pos in groups:
        gid = bins["gidx"][torch.clamp(pos, min=0)]
        f = base[gid].requires_grad_(True)
        px, py = _pixels(tiles, tiles_x, dtype)
        with torch.enable_grad():
            c4, ft = composite_group(f, pos >= 0, px, py)
            obj = (c4[..., :3] * g_color[tiles]).sum() + (ft * g_t[tiles]).sum()
            gf, = torch.autograd.grad(obj, f)
        gf = torch.where((pos >= 0)[..., None], gf, torch.zeros_like(gf))
        grad.index_add_(0, gid.reshape(-1), gf.reshape(-1, gf.shape[-1]))
    return grad


def render(params: dict, degrees, view: View, dtype=torch.float32, counts=False) -> dict:
    """Render ``params`` from ``view`` without gradients."""
    with torch.no_grad():
        pre = preprocess(params, degrees, view, dtype=dtype)
        bins = bin_entries(pre, view)
        out = render_forward(pre["fields"], bins, view, counts=counts)
    out["entries"] = int(bins["gidx"].numel())
    return out


def to_uint8(image: torch.Tensor) -> np.ndarray:
    """[3,H,W] in [0, 1] -> [H,W,3] uint8, truncating x 255."""
    return ((torch.clamp(image.float(), 0, 1) * 255).to(torch.uint8).cpu().numpy()
            .transpose(1, 2, 0))
