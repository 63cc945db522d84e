"""Per-tile alpha compositing of depth-sorted entries (counterpart of
reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:426-495, 655-817).

``composite_fwd`` is the forward compositor. On a CUDA tensor it launches
the hand-written kernel ``csrc/composite_fwd.cu`` (which replaces the
Pallas kernel ``_fwd_kernel``); on a CPU tensor it runs
``composite_fwd_plain``, the same function in plain PyTorch, written as the
JAX package's XLA path (log-space segmented scan). ``composite_fwd_stats``
is the same compositor with per-entry statistics (the Pallas kernel's
``with_stats=True`` form), likewise: the statistics form of
``csrc/composite_fwd.cu`` on CUDA, ``composite_fwd_stats_plain`` on the CPU.
``composite_bwd`` is the backward compositor, likewise: the kernel
``csrc/composite_bwd.cu`` (which replaces ``_bwd_kernel``) on CUDA,
``composite_bwd_plain`` (autograd through a recomputed forward) on the CPU.
There is no fallback from one to the other.

Entry fields are packed as rows of a [10, K] float32 matrix, in the JAX
kernel's order: 0 x, 1 y, 2 conic A, 3 conic B, 4 conic C, 5 opacity,
6 r, 7 g, 8 b, 9 depth. Tile t owns the sorted entries
[range_start[t], range_end[t]); the ranges partition [0, K) in tile order.
Tiles lie row-major, ``tiles_x`` to a row. A render of a band of tile rows
(the multi-device trainer's viewport) passes ``tile_row_offset``, the
image's tile row of the band's first row: tile t then covers the pixels of
image tile row t // tiles_x + tile_row_offset, at the same positions as in
the full render. It defaults to 0, the whole image.

Per pixel, front to back: power = -0.5 (A dx^2 + C dy^2) - B dx dy,
alpha = min(0.99, op e^power); an entry is skipped when power > 0 or
alpha < 1/255; the first entry with T (1 - alpha) < 1e-4 latches the pixel
and neither it nor any later entry contributes. Outputs per tile:
color4 [T,256,4] (sum of w (r, g, b, depth), w = alpha T), final_T
[T,256,1] and latch [T,256,1] int32, the sorted position of the latching
entry or range_end[t] when the pixel never latches. An empty tile gives
colour 0, T 1 and latch range_end[t].

A static key buffer (``tiled.bin_and_sort`` with ``key_buffer_size``) may
end in a tail of entries that lie in no tile's range: the kernels never
read them, B2 and B3 leave their per-entry outputs unwritten there, and the
plain versions give them zeros. Their Gaussian ids are scratch ids at and
past N, N + (position mod ``TAIL_SCRATCH``): ``gather_entries`` gathers
them from zero columns and ``sum_per_gaussian`` sums them into scratch rows
that it drops, so that whatever the buffer holds there reaches no Gaussian.
(Spread over that many rows, the tail's float atomics do not contend on
one address, which made the per-Gaussian sum tens of times slower on the
card; PERF.md §6.)

Each wrapper counts its launches in ``.launches``. A launch made while the
current stream captures a CUDA graph runs only when the graph is replayed:
it goes to ``captured_launches`` instead, and whoever replays the graph adds
what its capture recorded with ``add_replayed_launches``.
"""
from __future__ import annotations

import torch

from ... import config

N_FIELDS = 10
# Rows of the statistics compositor's per-entry output.
N_STATS = 4
# Pixels per step of the plain version: its [pixels, K] temporaries at the
# bench scene (K ~ 0.6M entries) must fit on the card.
_PIXEL_CHUNK = 32


# Scratch ids of a static key buffer's tail (see the module docstring).
TAIL_SCRATCH = 4096
# Launches recorded while a CUDA graph was being captured, by wrapper name.
captured_launches = {"composite_fwd": 0, "composite_fwd_stats": 0, "composite_bwd": 0}


def _count_launch(wrapper):
    if torch.cuda.is_current_stream_capturing():
        captured_launches[wrapper.__name__] += 1
    else:
        wrapper.launches += 1


def add_replayed_launches(tally: dict):
    """Count one replay of a graph whose capture recorded ``tally``
    (wrapper name -> launches) on each wrapper."""
    wrappers = {"composite_fwd": composite_fwd, "composite_fwd_stats": composite_fwd_stats,
                "composite_bwd": composite_bwd}
    for name, n in tally.items():
        wrappers[name].launches += n


def gather_entries(fields: torch.Tensor, s_gidx: torch.Tensor) -> torch.Tensor:
    """fields [R, N] gathered at the sorted entries' Gaussian ids [K], where
    the scratch ids at and past N (a static buffer's tail) read zeros:
    [R, K], contiguous."""
    return torch.nn.functional.pad(fields, (0, TAIL_SCRATCH)).index_select(1, s_gidx)


def sum_per_gaussian(per_entry: torch.Tensor, s_gidx: torch.Tensor, n: int) -> torch.Tensor:
    """per_entry [R, K] summed per Gaussian id into [R, n] with one
    ``index_add_``; entries with scratch ids (a static buffer's tail) go to
    scratch rows that are dropped."""
    out = torch.zeros((per_entry.shape[0], n + TAIL_SCRATCH), dtype=per_entry.dtype,
                      device=per_entry.device)
    return out.index_add_(1, s_gidx, per_entry)[:, :n]


def _valid_count(range_end: torch.Tensor) -> int:
    """The entries that lie in a tile's range: a prefix of the buffer."""
    return int(range_end[-1]) if range_end.numel() else 0


def pack_fields(pre) -> torch.Tensor:
    """Per-Gaussian field matrix [10, N] in the kernel's row order."""
    return torch.stack([
        pre.means2d[:, 0], pre.means2d[:, 1], pre.conic[:, 0],
        pre.conic[:, 1], pre.conic[:, 2], pre.opacity, pre.rgb[:, 0],
        pre.rgb[:, 1], pre.rgb[:, 2], pre.depths], dim=0)


def composite_fwd_plain(e: torch.Tensor, range_start: torch.Tensor,
                        range_end: torch.Tensor, tiles_x: int, tile_row_offset: int = 0):
    """Plain PyTorch version of the forward compositor.

    The JAX XLA path's formulation (tiled.py:516-563): per (pixel, entry)
    the incoming transmittance is exp of the segment-local exclusive sum of
    log(1 - alpha), and the latch is a segmented count of triggers. The sum
    runs in float64: a float32 running sum over all K entries would lose
    the segment-local values to cancellation at full-image K. Pixels go in
    chunks of ``_PIXEL_CHUNK``, with entries on the last axis so that every
    scan runs along contiguous memory.
    """
    return _composite_plain(e, range_start, range_end, tiles_x, tile_row_offset,
                            with_stats=False)


def composite_fwd_stats_plain(e: torch.Tensor, range_start: torch.Tensor,
                              range_end: torch.Tensor, tiles_x: int, tile_row_offset: int = 0):
    """Plain PyTorch version of the statistics compositor: the outputs of
    ``composite_fwd_plain`` and stats [4, K] float32, per sorted entry over
    the pixels it contributes to (the XLA path's tiled.py:552-560): the
    count, count x opacity, the sum of w and the sum of the incoming T."""
    return _composite_plain(e, range_start, range_end, tiles_x, tile_row_offset,
                            with_stats=True)


def _composite_plain(e, range_start, range_end, tiles_x, tile_row_offset, with_stats):
    K_buffer = e.shape[1]
    e = e[:, :_valid_count(range_end)]
    device = e.device
    K = e.shape[1]
    T = range_start.shape[0]
    P = config.BLOCK_SIZE
    rs = range_start.to(torch.int64)
    re = range_end.to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(T, device=device), re - rs, output_size=K)
    seg_start = rs[seg]                                              # [K]
    pos = torch.arange(K, device=device)
    x, y, A, B, C, op, r, g, b, depth = e
    tile_x = ((seg % tiles_x) * config.BLOCK_X).to(torch.float32)
    tile_y = ((seg // tiles_x + tile_row_offset) * config.BLOCK_Y).to(torch.float32)

    # Per (pixel, tile): sums of w r, w g, w b, w depth and log T.
    sums = torch.zeros(P, T, 5, dtype=e.dtype, device=device)
    latch = re.expand(P, T).contiguous()
    # Per entry: contributing pixels, sum of w, sum of T_in.
    counts = torch.zeros(K, dtype=torch.int64, device=device)
    w_sum = torch.zeros(K, dtype=e.dtype, device=device)
    t_sum = torch.zeros(K, dtype=e.dtype, device=device)
    for p0 in range(0, P, _PIXEL_CHUNK):
        p = torch.arange(p0, min(p0 + _PIXEL_CHUNK, P), device=device)[:, None]
        dx = x - (tile_x + (p % config.BLOCK_X).to(torch.float32))     # [p,K]
        dy = y - (tile_y + (p // config.BLOCK_X).to(torch.float32))
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        # Gate before using exp(power): power > 0 can overflow.
        gate = power <= 0.0
        alpha = torch.clamp(op * torch.exp(torch.where(gate, power, torch.zeros_like(power))),
                            max=config.ALPHA_MAX)
        gate &= alpha >= config.ALPHA_EPS
        abar = torch.where(gate, alpha, torch.zeros_like(alpha))
        log1ma = torch.log1p(-abar)

        lex = torch.cumsum(log1ma.double(), dim=1) - log1ma.double()  # exclusive
        T_in = torch.exp((lex - lex[:, seg_start]).to(e.dtype))      # segment-local
        trigger = gate & (T_in * (1.0 - abar) < config.T_EPS)
        tcum_ex = torch.cumsum(trigger.to(torch.int32), dim=1) - trigger.to(torch.int32)
        dead = (tcum_ex - tcum_ex[:, seg_start]) > 0
        contrib = gate & ~trigger & ~dead

        w = torch.where(contrib, abar * T_in, torch.zeros_like(abar))  # [p,K]
        vals = torch.stack([w * r, w * g, w * b, w * depth,
                            torch.where(contrib, log1ma, torch.zeros_like(log1ma))], dim=-1)
        sums[p0:p0 + p.shape[0]].index_add_(1, seg, vals)
        cand = torch.where(trigger & ~dead, pos, torch.full_like(pos, K))
        latch[p0:p0 + p.shape[0]].scatter_reduce_(1, seg.expand_as(cand), cand, reduce="amin")
        if with_stats:
            counts += contrib.sum(dim=0)
            w_sum += w.sum(dim=0)
            t_sum += torch.where(contrib, T_in, torch.zeros_like(T_in)).sum(dim=0)
    color4 = sums[..., :4].transpose(0, 1).contiguous()
    final_t = torch.exp(sums[..., 4]).T.contiguous()[:, :, None]
    latch = latch.T.to(torch.int32).contiguous()[:, :, None]
    if not with_stats:
        return color4, final_t, latch
    cnt = counts.to(e.dtype)
    stats = torch.stack([cnt, cnt * op, w_sum, t_sum])
    return color4, final_t, latch, torch.nn.functional.pad(stats, (0, K_buffer - K))


def _check_inputs(e, range_start, range_end):
    if e.dtype != torch.float32 or e.dim() != 2 or e.shape[0] != N_FIELDS:
        raise ValueError(f"e must be float32 [{N_FIELDS}, K], got {e.dtype} {tuple(e.shape)}")
    for nm, t in (("range_start", range_start), ("range_end", range_end)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{nm} must be int32 [T], got {t.dtype} {tuple(t.shape)}")
        if t.device != e.device:
            raise ValueError(f"{nm} is on {t.device}, e on {e.device}")
    if range_start.shape != range_end.shape:
        raise ValueError("range_start and range_end differ in shape")


def composite_fwd(e: torch.Tensor, range_start: torch.Tensor,
                  range_end: torch.Tensor, tiles_x: int, tile_row_offset: int = 0):
    """Forward compositor: (color4 [T,256,4], final_T [T,256,1],
    latch [T,256,1] int32) for sorted entries ``e`` [10, K], the band of
    tile rows from ``tile_row_offset`` (0: the whole image).

    CPU tensors go to ``composite_fwd_plain``. CUDA tensors launch the CUDA
    kernel and add one to ``composite_fwd.launches``; any other device
    raises."""
    _check_inputs(e, range_start, range_end)
    if e.device.type == "cpu":
        return composite_fwd_plain(e, range_start, range_end, tiles_x, tile_row_offset)
    return _launch_fwd(composite_fwd, e, range_start, range_end, tiles_x, tile_row_offset)


composite_fwd.launches = 0


def composite_fwd_stats(e: torch.Tensor, range_start: torch.Tensor,
                        range_end: torch.Tensor, tiles_x: int, tile_row_offset: int = 0):
    """Statistics compositor: the outputs of ``composite_fwd`` and stats
    [4, K] float32, per sorted entry over the pixels it contributes to
    (gated and before the pixel's latch; pixels outside the image count,
    as in the JAX package): the count, count x opacity, the sum of the
    blend weights w = alpha T_in and the sum of the incoming transmittance
    T_in. Entries the walk never reaches get zeros. Not differentiable.

    CPU tensors go to ``composite_fwd_stats_plain``. CUDA tensors launch the
    CUDA kernel (``composite_fwd.cu``'s statistics form) and add one to
    ``composite_fwd_stats.launches``; any other device raises."""
    _check_inputs(e, range_start, range_end)
    if e.device.type == "cpu":
        return composite_fwd_stats_plain(e, range_start, range_end, tiles_x, tile_row_offset)
    return _launch_fwd(composite_fwd_stats, e, range_start, range_end, tiles_x,
                       tile_row_offset)


composite_fwd_stats.launches = 0


def _launch_fwd(wrapper, e, range_start, range_end, tiles_x, tile_row_offset):
    """Launch the kernel of ``csrc/composite_fwd.cu`` that ``wrapper`` (one
    of the two functions above) names, with its stats output for
    ``composite_fwd_stats``, and count the launch on ``wrapper``."""
    symbol = wrapper.__name__
    if e.device.type != "cuda":
        raise ValueError(f"{symbol} runs on cpu or cuda tensors, not {e.device}")
    for nm, t in (("e", e), ("range_start", range_start), ("range_end", range_end)):
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    from ._build import load_library
    lib = load_library("composite_fwd")
    K = e.shape[1]
    T = range_start.shape[0]
    color4 = torch.empty((T, config.BLOCK_SIZE, 4), dtype=torch.float32, device=e.device)
    final_t = torch.empty((T, config.BLOCK_SIZE, 1), dtype=torch.float32, device=e.device)
    latch = torch.empty((T, config.BLOCK_SIZE, 1), dtype=torch.int32, device=e.device)
    outs = [color4, final_t, latch]
    if symbol == "composite_fwd_stats":
        outs.append(torch.empty((N_STATS, K), dtype=torch.float32, device=e.device))
    if T > 0:
        with torch.cuda.device(e.device):
            stream = torch.cuda.current_stream(e.device).cuda_stream
            order = torch.empty(T, dtype=torch.int32, device=e.device)  # filled by the launch
            err = getattr(lib, symbol)(
                e.data_ptr(), K, range_start.data_ptr(), range_end.data_ptr(),
                order.data_ptr(), T, tiles_x, tile_row_offset,
                *(t.data_ptr() for t in outs), stream)
        if err != 0:
            raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
        _count_launch(wrapper)
    return tuple(outs)


def composite_bwd_plain(e: torch.Tensor, range_start: torch.Tensor,
                        range_end: torch.Tensor, tiles_x: int, final_t: torch.Tensor,
                        latch: torch.Tensor, g_color4: torch.Tensor,
                        g_t: torch.Tensor, tile_row_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the backward compositor: the per-entry
    gradients [10, K] of <g_color4, color4> + <g_t, final_T>.

    It shares no formula with the kernel: for each chunk of
    ``_PIXEL_CHUNK`` pixels it recomputes the forward quantities as
    ``composite_fwd_plain`` does, with the contributing set taken from the
    given ``latch`` (gated and at a sorted position below the latch), and
    lets autograd differentiate them. Pixels are independent, so the sum of
    the chunks' gradients is the gradient. ``final_t`` is recomputed, not
    read; it is in the signature so that both versions take the same
    arguments. The alpha clamp is ``where(raw < 0.99, raw, 0.99)``, whose
    subgradient is the JAX package's strict ``<``."""
    del final_t
    all_grads = torch.zeros_like(e)
    grads = all_grads[:, :_valid_count(range_end)]
    e = e[:, :grads.shape[1]]
    device = e.device
    K = e.shape[1]
    T = range_start.shape[0]
    P = config.BLOCK_SIZE
    if K == 0:
        return all_grads
    rs = range_start.to(torch.int64)
    re = range_end.to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(T, device=device), re - rs, output_size=K)
    seg_start = rs[seg]
    pos = torch.arange(K, device=device)
    tile_x = ((seg % tiles_x) * config.BLOCK_X).to(torch.float32)
    tile_y = ((seg // tiles_x + tile_row_offset) * config.BLOCK_Y).to(torch.float32)
    lat = latch[..., 0].to(torch.int64)
    with torch.enable_grad():
        for p0 in range(0, P, _PIXEL_CHUNK):
            p1 = min(p0 + _PIXEL_CHUNK, P)
            p = torch.arange(p0, p1, device=device)[:, None]
            ev = e.detach().requires_grad_(True)
            x, y, A, B, C, op, r, g, b, depth = ev
            dx = x - (tile_x + (p % config.BLOCK_X).to(torch.float32))     # [p,K]
            dy = y - (tile_y + (p // config.BLOCK_X).to(torch.float32))
            power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
            gate = power <= 0.0
            raw = op * torch.exp(torch.where(gate, power, torch.zeros_like(power)))
            alpha = torch.where(raw < config.ALPHA_MAX, raw, config.ALPHA_MAX)
            contrib = gate & (alpha >= config.ALPHA_EPS) & (pos < lat[:, p0:p1].T[:, seg])
            abar = torch.where(contrib, alpha, torch.zeros_like(alpha))
            log1ma = torch.log1p(-abar)
            lex = torch.cumsum(log1ma.double(), dim=1) - log1ma.double()  # exclusive
            T_in = torch.exp((lex - lex[:, seg_start]).to(e.dtype))      # segment-local
            gc = g_color4[:, p0:p1].transpose(0, 1)[:, seg]              # [p,K,4]
            cdotg = r * gc[..., 0] + g * gc[..., 1] + b * gc[..., 2] + depth * gc[..., 3]
            final = torch.exp(torch.zeros(p1 - p0, T, dtype=e.dtype, device=device)
                              .index_add(1, seg, log1ma))
            objective = (abar * T_in * cdotg).sum() + (g_t[:, p0:p1, 0].T * final).sum()
            grads += torch.autograd.grad(objective, ev)[0]
    return all_grads


def composite_bwd(e: torch.Tensor, range_start: torch.Tensor, range_end: torch.Tensor,
                  tiles_x: int, final_t: torch.Tensor, latch: torch.Tensor,
                  g_color4: torch.Tensor, g_t: torch.Tensor,
                  tile_row_offset: int = 0) -> torch.Tensor:
    """Backward compositor: per-entry gradients [10, K], in sorted order, of
    d(x, y, A, B, C, op, r, g, b, depth) for the cotangents g_color4
    [T,256,4] and g_t [T,256,1], given the forward's final_T and latch, for
    the band of tile rows from ``tile_row_offset`` (0: the whole image).

    CPU tensors go to ``composite_bwd_plain``. CUDA tensors launch the CUDA
    kernel and add one to ``composite_bwd.launches``; any other device
    raises. The kernel sums each entry's per-pixel terms with shared-memory
    float atomics, so the last bits of a gradient vary between runs."""
    _check_inputs(e, range_start, range_end)
    T = range_start.shape[0]
    for nm, t, width, dtype in (("final_t", final_t, 1, torch.float32),
                                ("latch", latch, 1, torch.int32),
                                ("g_color4", g_color4, 4, torch.float32),
                                ("g_t", g_t, 1, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (T, config.BLOCK_SIZE, width):
            raise ValueError(f"{nm} must be {dtype} [{T}, {config.BLOCK_SIZE}, {width}], "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != e.device:
            raise ValueError(f"{nm} is on {t.device}, e on {e.device}")
    if e.device.type == "cpu":
        return composite_bwd_plain(e, range_start, range_end, tiles_x, final_t, latch,
                                   g_color4, g_t, tile_row_offset)
    if e.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on cpu or cuda tensors, not {e.device}")
    args = (("e", e), ("range_start", range_start), ("range_end", range_end),
            ("final_t", final_t), ("latch", latch), ("g_color4", g_color4), ("g_t", g_t))
    for nm, t in args:
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    from ._build import load_library
    lib = load_library("composite_bwd")
    K = e.shape[1]
    grads = torch.empty((N_FIELDS, K), dtype=torch.float32, device=e.device)
    if T > 0:
        with torch.cuda.device(e.device):
            stream = torch.cuda.current_stream(e.device).cuda_stream
            order = torch.empty(T, dtype=torch.int32, device=e.device)  # filled by the launch
            err = lib.composite_bwd(
                e.data_ptr(), K, range_start.data_ptr(), range_end.data_ptr(),
                order.data_ptr(), T, tiles_x, tile_row_offset, final_t.data_ptr(),
                latch.data_ptr(),
                g_color4.data_ptr(), g_t.data_ptr(), grads.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error {err}")
        _count_launch(composite_bwd)
    return grads


composite_bwd.launches = 0


class CompositeSorted(torch.autograd.Function):
    """Differentiable compositing straight from per-Gaussian fields
    (counterpart of ``composite_sorted``): gathers the sorted entries
    ``fields10[:, s_gidx]`` and runs ``composite_fwd``.

    apply(fields10 [10,N], s_gidx [K], range_start [T], range_end [T],
    tiles_x[, tile_row_offset]) -> (color4 [T,256,4], final_T [T,256,1]),
    ``tile_row_offset`` 0 (the whole image) when left out. It saves the entry
    buffer, the entries' Gaussian ids, final_T and the latch. The backward
    runs ``composite_bwd`` into per-entry gradients [10, K] and sums them
    per Gaussian into [10, N] with one ``index_add_`` (``sum_per_gaussian``:
    a static buffer's tail, whose ids are N, lands in a dropped row). (The JAX package's
    scatter-free prefix difference, ``segment_reduce_emission``, exists
    because XLA's scatter-add is serial on a TPU; it is not ported.) On
    CUDA the sum uses float atomics, so its last bits vary between runs."""

    @staticmethod
    def forward(ctx, fields10, s_gidx, range_start, range_end, tiles_x, tile_row_offset=0):
        e = gather_entries(fields10, s_gidx)
        color4, final_t, latch = composite_fwd(e, range_start, range_end, tiles_x,
                                               tile_row_offset)
        ctx.save_for_backward(e, s_gidx, range_start, range_end, final_t, latch)
        ctx.tiles_x = tiles_x
        ctx.tile_row_offset = tile_row_offset
        ctx.num_gaussians = fields10.shape[1]
        return color4, final_t

    @staticmethod
    def backward(ctx, g_color4, g_t):
        e, s_gidx, range_start, range_end, final_t, latch = ctx.saved_tensors
        g_entries = composite_bwd(e, range_start, range_end, ctx.tiles_x, final_t, latch,
                                  g_color4.contiguous(), g_t.contiguous(),
                                  ctx.tile_row_offset)
        dfields = sum_per_gaussian(g_entries, s_gidx, ctx.num_gaussians)
        # (autograd drops the trailing None when tile_row_offset was left out)
        return dfields, None, None, None, None, None
