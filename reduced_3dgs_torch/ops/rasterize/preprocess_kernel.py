"""The per-Gaussian preprocess as one autograd Function over two CUDA
kernels (``csrc/preprocess.cu``). It replaces no TPU kernel: the JAX package
leaves the preprocess (reduced_3dgs_tpu/ops/rasterize/common.py:49-183) to
XLA, which fuses it; in eager PyTorch the same code is some 240 small kernels
forward and 600 in its autograd, so the port fuses it by hand.

``Preprocess.apply(means3d, opacities_raw, scales, rotations, shs,
mean2d_offset_ndc, colors_precomp, viewmatrix, projmatrix, campos, settings)``
-> (fields [10,N] float32 in ``composite.pack_fields``' row order, radii [N],
rect_min [N,2], rect_max [N,2], tiles_touched [N], all int32): what
``common.preprocess_plain`` returns, with the float fields as the rows of the
compositor's field matrix. ``mean2d_offset_ndc`` and ``colors_precomp`` may be
None; with ``colors_precomp`` ``shs`` is not read and may be None. The
camera's three tensors are arguments of their own so that their gradients
reach them when they require grad (the learned poses of the camera modes).

The forward launches ``preprocess_fwd`` and the backward ``preprocess_bwd``;
both take CUDA tensors only (``common.preprocess`` sends CPU tensors to
``preprocess_plain``). The backward recomputes the forward's intermediates
from the inputs and saves nothing else. It reproduces the plain autograd's
conventions: a clamp passes its gradient at the limits inclusive, the
colour's ``maximum(rgb, 0)`` passes half of it at exactly 0, rows with a
zero determinant get a zero conic and no gradient through it, culled rows
take view z = 1 in the Jacobian, and the depth row's gradient reaches the
means and the view matrix. The camera's gradients are summed per block and
then over the blocks in a fixed order (no float atomics), so they repeat
exactly from run to run.

Each wrapper counts its launches in ``.launches`` as the compositors' do
(``launches``).
"""
from __future__ import annotations

import torch

from .. import projection as proj
from .. import sh as sh_ops
from . import common, composite
from .launches import counted, launch

N_FIELDS = composite.N_FIELDS
# The camera gradient's floats: viewmatrix [16], projmatrix [16], campos [3].
N_CAMERA = 35
# Gaussians a block of either kernel takes (csrc/preprocess.cu's kBlock): the
# backward writes one row of the camera's partial sums per block.
BLOCK = 128


def _degree(shs, colors_precomp, settings) -> int:
    """The SH degree the kernels evaluate, -1 for given colours."""
    if colors_precomp is not None:
        return -1
    return min(int(settings.sh_degree), sh_ops.MAX_SH_DEGREE)


def _scalars(settings):
    """The settings' numbers in the order of the launchers' arguments
    (after the camera's pointers): H, W, tiles_x, tiles_y, focal_x,
    focal_y, the 1.3 tan-FoV clamps and the scale modifier."""
    H, W = settings.image_height, settings.image_width
    tiles_x, tiles_y = common.tile_grid(settings)
    focal_x, focal_y = proj.focals_from_fov(W, H, settings.tanfovx, settings.tanfovy)
    return (H, W, tiles_x, tiles_y, focal_x, focal_y, 1.3 * settings.tanfovx,
            1.3 * settings.tanfovy, settings.scale_modifier)


def _check(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
           colors_precomp, viewmatrix, projmatrix, campos, degree):
    """Device, dtype, shape and contiguity of the kernels' inputs (``campos``
    may be strided: the camera centre is a row of an inverse); raises
    ValueError on what they do not take."""
    n = means3d.shape[0] if means3d.dim() == 2 else -1
    shapes = [("means3d", means3d, (n, 3)), ("scales", scales, (n, 3)),
              ("rotations", rotations, (n, 4)), ("viewmatrix", viewmatrix, (4, 4)),
              ("projmatrix", projmatrix, (4, 4)),
              ("opacities_raw", opacities_raw,
               (n, 1) if opacities_raw.dim() == 2 else (n,))]
    if mean2d_offset_ndc is not None:
        shapes.append(("mean2d_offset_ndc", mean2d_offset_ndc, (n, 2)))
    if degree < 0:
        shapes.append(("colors_precomp", colors_precomp, (n, 3)))
    elif shs is None or shs.dim() != 3 or shs.shape[0] != n or shs.shape[2] != 3 \
            or shs.shape[1] < sh_ops.num_sh_coeffs(degree):
        raise ValueError(f"shs must be [{n}, >= {sh_ops.num_sh_coeffs(degree)}, 3], got "
                         f"{None if shs is None else tuple(shs.shape)}")
    else:
        shapes.append(("shs", shs, tuple(shs.shape)))
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if t.device != means3d.device:
            raise ValueError(f"{name} is on {t.device}, means3d on {means3d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if campos.dtype != torch.float32 or tuple(campos.shape) != (3,) \
            or campos.device != means3d.device:
        raise ValueError(f"campos must be float32 [3] on {means3d.device}, got {campos.dtype} "
                         f"{list(campos.shape)} on {campos.device}")
    if rotations.data_ptr() % 16:
        raise ValueError("rotations must start on 16 bytes (one 128-bit load a row)")


def _aligned(shs) -> int:
    """Whether every SH row starts on 16 bytes (float4 loads and stores)."""
    return int(shs is not None and shs.data_ptr() % 16 == 0 and shs.shape[1] * 3 % 4 == 0)


@counted
def preprocess_fwd(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
                   colors_precomp, viewmatrix, projmatrix, campos, settings):
    """The forward kernel: (fields [10,N], radii, rect_min, rect_max,
    tiles_touched) of ``Preprocess``. CUDA tensors only; adds one to
    ``preprocess_fwd.launches``."""
    degree = _degree(shs, colors_precomp, settings)
    _check(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc, colors_precomp,
           viewmatrix, projmatrix, campos, degree)
    if means3d.device.type != "cuda":
        raise ValueError(f"preprocess_fwd runs on cuda tensors, not {means3d.device}")
    n = means3d.shape[0]
    device = means3d.device
    fields = torch.empty((N_FIELDS, n), dtype=torch.float32, device=device)
    radii = torch.empty(n, dtype=torch.int32, device=device)
    rect_min = torch.empty((n, 2), dtype=torch.int32, device=device)
    rect_max = torch.empty((n, 2), dtype=torch.int32, device=device)
    tiles = torch.empty(n, dtype=torch.int32, device=device)
    if n > 0:
        launch(preprocess_fwd, "preprocess_fwd", device, n, degree,
               0 if shs is None or degree < 0 else shs.shape[1] * 3,
               _aligned(shs) if degree >= 0 else 0, means3d, opacities_raw, scales, rotations,
               shs if degree >= 0 else None, colors_precomp, mean2d_offset_ndc, viewmatrix,
               projmatrix, campos, campos.stride(0), *_scalars(settings), fields, radii,
               rect_min, rect_max, tiles)
    return fields, radii, rect_min, rect_max, tiles


@counted
def preprocess_bwd(g_fields, means3d, opacities_raw, scales, rotations, shs, colors_precomp,
                   viewmatrix, projmatrix, campos, settings, needs):
    """The backward kernel: the gradients of ``Preprocess``'s ten tensor
    inputs for the field gradient ``g_fields`` [10,N] (rows contiguous, any
    row stride), each None unless ``needs`` (``ctx.needs_input_grad``) asks
    for it. The camera's three come from per-block sums and one fixed-order
    sum over them (a second kernel). CUDA tensors only; adds one to
    ``preprocess_bwd.launches``."""
    n = means3d.shape[0]
    if g_fields.dtype != torch.float32 or tuple(g_fields.shape) != (N_FIELDS, n) \
            or g_fields.stride(1) != 1 or g_fields.device != means3d.device:
        raise ValueError(f"g_fields must be float32 [{N_FIELDS}, {n}] on {means3d.device} "
                         f"with contiguous rows")
    degree = _degree(shs, colors_precomp, settings)
    _check(means3d, opacities_raw, scales, rotations, shs, None, colors_precomp,
           viewmatrix, projmatrix, campos, degree)
    if means3d.device.type != "cuda":
        raise ValueError(f"preprocess_bwd runs on cuda tensors, not {means3d.device}")
    device = means3d.device

    def empty_if(i, like):
        return torch.empty_like(like) if needs[i] else None

    # shs is not read when colours are given, nor the colours otherwise.
    grads = [empty_if(0, means3d), empty_if(1, opacities_raw), empty_if(2, scales),
             empty_if(3, rotations), empty_if(4, shs) if degree >= 0 else None,
             torch.empty((n, 2), dtype=torch.float32, device=device) if needs[5] else None,
             empty_if(6, colors_precomp) if degree < 0 else None,
             None, None, None]
    camera = any(needs[7:10])
    blocks = -(-n // BLOCK)
    partial = torch.empty((max(blocks, 1), N_CAMERA), dtype=torch.float32,
                          device=device) if camera else None
    cam = torch.empty(N_CAMERA, dtype=torch.float32, device=device) if camera else None
    if n > 0:
        launch(preprocess_bwd, "preprocess_bwd", device, n, degree,
               0 if shs is None or degree < 0 else shs.shape[1] * 3,
               _aligned(shs) if degree >= 0 else 0, means3d, opacities_raw, scales, rotations,
               shs if degree >= 0 else None, viewmatrix, projmatrix, campos, campos.stride(0),
               *_scalars(settings), g_fields, g_fields.stride(0), *grads[:7], partial, cam)
    elif camera:
        cam.zero_()
    if camera:
        for i, part in ((7, cam[:16].view(4, 4)), (8, cam[16:32].view(4, 4)), (9, cam[32:])):
            grads[i] = part if needs[i] else None
        if degree <= 0:
            grads[9] = None     # the colour does not depend on the camera's centre
    return tuple(grads)


class Preprocess(torch.autograd.Function):
    """The preprocess (see the module docstring); ``settings`` gives the
    image, the FoV, the scale modifier and the SH degree."""

    @staticmethod
    def forward(ctx, means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
                colors_precomp, viewmatrix, projmatrix, campos, settings):
        out = preprocess_fwd(means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc,
                             colors_precomp, viewmatrix, projmatrix, campos, settings)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(means3d, opacities_raw, scales, rotations, shs, colors_precomp,
                              viewmatrix, projmatrix, campos)
        ctx.settings = settings
        return out

    @staticmethod
    def backward(ctx, g_fields, *_):
        saved = ctx.saved_tensors
        if g_fields.stride(1) != 1:
            g_fields = g_fields.contiguous()
        return (*preprocess_bwd(g_fields, *saved, ctx.settings, ctx.needs_input_grad[:10]),
                None)
