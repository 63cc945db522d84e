"""Where the compositor kernels' time goes on the card.

Run from the repository root (it takes the bench scene from chip_smoke.py)
on a machine with one NVIDIA GPU and nvcc::

    python -m reduced_3dgs_torch.ops.rasterize.kernel_study [--parent DIR] [--out FILE]

At the 200k-Gaussian 544x976 bench scene, camera 0, for the kernels of
``csrc/composite_fwd.cu`` (B1 ``composite_fwd``, B2 ``composite_fwd_stats``)
and ``csrc/composite_bwd.cu`` (B3 ``composite_bwd``) it prints:

- each kernel's registers, shared memory and spills (``nvcc -Xptxas -v``);
- the per-tile entry counts, and the (warp, entry) visits each kernel's walk
  makes, with warps of two pixel rows or of 8 x 4 pixels, before and after
  the warps' cull;
- each kernel's per-tile timeline: ``%globaltimer`` at every block's start
  and end, from a copy of the source that records it;
- the time of copies of the sources changed by text substitution
  (``ABLATIONS``: shuffles removed, loads removed or doubled, FMA allowed in
  the gate, other group sizes, the statistics' slots as shared atomics,
  tiles launched in another order), each built by nvcc into a temporary
  directory and timed in turns with the source as it is. A copy of
  ``composite_fwd.cu`` is timed as B1 and as B2, a ``stats_`` copy as B2
  only.

With ``--parent DIR`` the ``composite_fwd.cu`` and ``composite_bwd.cu`` in DIR
(another commit's, say) are built and timed in the same turns, with the
substitutions that apply to their text. Every time is the median of 20
CUDA-event timings after 3 warm-up runs (chip_smoke.cuda_ms); each library
is timed twice, in two rounds of opposite order. Outputs of the copies are
not checked, except that the copies that only time blocks or reorder them
must give the real kernel's outputs (bit for bit, or for B3, whose sums
take an order that varies, within 1e-6 of each field's largest value). ``--out`` writes the record as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from . import _build

# Copies of a source by text substitution: name -> (source, alternatives,
# what the copy shows). Each alternative is a tuple of (old, new) pairs; a
# copy is built from every source text (this tree's, and the parent's with
# --parent) with the first alternative whose every `old` occurs there
# exactly once. Sources before the redesign stage each field in its own
# row of `fields` and sum each field with a butterfly; after it, entries are
# staged as three float4 and summed by a reduce-scatter.
_FWD_GATE_OP_BY_OP = (
    "  const float power = __fsub_rn(\n"
    "      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn({A}, dx), dx),\n"
    "                                 __fmul_rn(__fmul_rn({C}, dy), dy))),\n"
    "      __fmul_rn(__fmul_rn({B}, dx), dy));")
_FWD_GATE_FMA = "  const float power = -0.5f * ({A} * dx * dx + {C} * dy * dy) - {B} * dx * dy;"
_TILE_LINE = "const int tile = blockIdx.x;"
_ORDERED_TILE_LINE = "const int tile = tile_order[blockIdx.x];"
ABLATIONS = {
    "bwd_no_shuffle": ("composite_bwd", (
        (("v += __shfl_xor_sync(kFullMask, v, offset);", "v += v;"),),
        (("v[0] += __shfl_xor_sync(kFullMask, v[0], kOffset);", "v[0] += v[0];"),
         ("__shfl_xor_sync(kFullMask, upper ? lo : hi, kOffset)", "(upper ? lo : hi)"))),
        "the warp sums' shuffles removed"),
    "bwd_colour_from_op": ("composite_bwd", (tuple(
        (f"fields[{f}][j] * g4.{c}", f"fields[5][j] * g4.{c}")
        for f, c in zip(range(6, 10), "xyzw")),),
        "the four colour loads of a contributing entry removed (op read instead)"),
    "bwd_loads_x2": ("composite_bwd", ((
        ("const float op = fields[5][j];",
         "const float op = fields[5][j];\n      float extra = 0.0f;\n"
         "      for (int f = 0; f < kFields; ++f) extra += fields[f][j & ~1];"),
        ("if (__any_sync(kFullMask, contrib)) {",
         "g[9] += 0.0f * extra;\n      if (__any_sync(kFullMask, contrib)) {")),),
        "ten more scalar shared loads per visit"),
    "bwd_group2": ("composite_bwd", (
        (("constexpr int kGroup = 1;", "constexpr int kGroup = 2;"),),),
        "two entries per reduce-scatter"),
    "bwd_group3": ("composite_bwd", (
        (("constexpr int kGroup = 1;", "constexpr int kGroup = 3;"),),),
        "three entries per reduce-scatter"),
    "bwd_no_cull": ("composite_bwd", (
        (("tile_common::may_touch(", "(true || tile_common::may_touch("),
         ("box.y0, box.y1);", "box.y0, box.y1));")),),
        "every warp visits every entry before its latch (no cull)"),
    "bwd_rows": ("composite_bwd", (
        (("constexpr int kWarpWidth = 8;", "constexpr int kWarpWidth = 16;"),),),
        "a warp covers two pixel rows of 16 instead of 8 x 4 pixels"),
    "bwd_batch64": ("composite_bwd", (
        (("constexpr int kBatch = 128;", "constexpr int kBatch = 64;"),),),
        "batches of 64 entries"),
    "bwd_batch256": ("composite_bwd", (
        (("constexpr int kBatch = 128;", "constexpr int kBatch = 256;"),),),
        "batches of 256 entries"),
    "bwd_no_overlap": ("composite_bwd", (
        (("    __pipeline_commit();\n", "    __pipeline_commit();\n    __pipeline_wait_prior(0);\n"),),),
        "each batch's copy waited for at once: no overlap with the walk"),
    "bwd_occupancy5": ("composite_bwd", (
        (("__launch_bounds__(kPixels)\ncomposite_bwd_kernel",
          "__launch_bounds__(kPixels, 5)\ncomposite_bwd_kernel"),),),
        "at most 51 registers: five blocks per SM"),
    "bwd_one_reciprocal": ("composite_bwd", (
        (("const float T_in = T / one_m;",
          "const float inv = 1.0f / one_m;\n            const float T_in = T * inv;"),
         ("S / one_m", "S * inv")),),
        "one reciprocal and two products for the two divisions by 1 - alpha"),
    "bwd_block_start": ("composite_bwd", (
        (("const int jtop = min(hi, my_stop) - lo;", "const int jtop = hi - lo;"),),),
        "every warp walks from the block's largest latch"),
    "fwd_fma_gate": ("composite_fwd", tuple(
        ((_FWD_GATE_OP_BY_OP.format(**r), _FWD_GATE_FMA.format(**r)),)
        for r in (dict(A="fields[2][j]", B="fields[3][j]", C="fields[4][j]"),
                  dict(A="q0.z", B="q0.w", C="q1.x"))),
        "the gate's quadratic form with FMA contraction allowed"),
    "fwd_no_cull": ("composite_fwd", (
        (("tile_common::may_touch(", "(true || tile_common::may_touch("),
         ("box.y0, box.y1);", "box.y0, box.y1));")),),
        "every warp visits every entry (no cull)"),
    "fwd_rows": ("composite_fwd", (
        (("constexpr int kWarpWidth = 8;", "constexpr int kWarpWidth = 16;"),),),
        "a warp covers two pixel rows of 16 instead of 8 x 4 pixels"),
    "fwd_no_overlap": ("composite_fwd", (
        (("    __pipeline_commit();\n", "    __pipeline_commit();\n    __pipeline_wait_prior(0);\n"),),),
        "each batch's copy waited for at once: no overlap with the walk"),
    "fwd_occupancy8": ("composite_fwd", (
        (("__launch_bounds__(kPixels)\ncomposite_fwd_kernel",
          "__launch_bounds__(kPixels, 8)\ncomposite_fwd_kernel"),),),
        "at most 32 registers: eight blocks per SM"),
    "fwd_colour_from_op": ("composite_fwd", (tuple(
        (f"{acc} += w * fields[{f}][j];", f"{acc} += w * fields[5][j];")
        for acc, f in zip(("cr", "cg", "cb", "cd"), range(6, 10))),),
        "the four colour loads of a contributing entry removed (op read instead)"),
    "fwd_loads_x2": ("composite_fwd", ((
        ("const float dx = fields[0][j] - px;",
         "float extra = 0.0f;\n  for (int f = 0; f < kFields; ++f) extra += "
         "fields[f][j & ~1];\n  const float dx = fields[0][j] - px + 0.0f * extra;"),),),
        "ten more scalar shared loads per visit"),
    # Copies of the statistics form (B2) alone, timed as B2 only.
    # stats_skip_latched applies to the design before the warps' cull,
    # stats_atomics to the one after it, stats_no_shuffle to both.
    "stats_no_shuffle": ("composite_fwd", (
        (("__shfl_xor_sync(kFullMask, upper ? a : b, 16)", "(upper ? a : b)"),
         ("v += __shfl_xor_sync(kFullMask, v, offset);", "v += v;")),
        (("v += __shfl_xor_sync(kFullMask, v, offset);", "v += v;"),)),
        "the statistics' shuffles removed"),
    "stats_skip_latched": ("composite_fwd", (
        (("for (int j = 0; j < n; ++j) {",
          "for (int j = 0; j < n && !__all_sync(kFullMask, done); ++j) {"),),),
        "a warp stops visiting the batch once all of its pixels have latched"),
    "stats_atomics": ("composite_fwd", ((
        ("  unsigned char count[kWarps][kPixels];\n  float w[kWarps][kPixels];\n"
         "  float t[kWarps][kPixels];\n",
         "  unsigned char count[1][kPixels];\n  float w[2][kPixels];\n  float t[1][kPixels];\n"),
        ("    count[warp][j] = 0;\n    w[warp][j] = 0.0f;\n    t[warp][j] = 0.0f;\n", ""),
        ("        if (lane == 0) {\n          slots.count[warp][j] = __popc(who);\n"
         "          slots.w[warp][j] = sum;\n        } else if (lane == 16) {\n"
         "          slots.t[warp][j] = sum;\n        }\n",
         "        if (who && lane == 0) {\n"
         "          atomicAdd(reinterpret_cast<int*>(slots.w[1]) + j, __popc(who));\n"
         "          atomicAdd(&slots.w[0][j], sum);\n        } else if (who && lane == 16) {\n"
         "          atomicAdd(&slots.t[0][j], sum);\n        }\n"),
        ("for (int w = 0; w < kWarps; ++w) {", "for (int w = 0; w < 1; ++w) {"),
        ("count += slots.count[w][tid];", "count += reinterpret_cast<int*>(slots.w[1])[tid];"),
        ("ts += slots.t[w][tid];",
         "ts += slots.t[w][tid];\n          slots.w[0][tid] = slots.w[1][tid] = slots.t[0][tid] = 0.0f;"),
        ("  const int end = range_end[tile];\n",
         "  const int end = range_end[tile];\n  if constexpr (kWithStats) {\n"
         "    slots.w[0][tid] = slots.w[1][tid] = slots.t[0][tid] = 0.0f;\n  }\n")),),
        "the warps' sums added into one slot per entry with shared atomics (an int count, "
        "two floats), which the combine reads and clears"),
    # Instrumented copies (any source). The timeline copies record
    # globaltimer at each block's start and end (thread 0's, as it leaves the
    # kernel); heavy_first and index_order change the order in which blocks
    # take tiles.
    "timeline": (None, (
        (("#include <cuda_runtime.h>\n", "{prelude}"),
         (_TILE_LINE, _TILE_LINE + " study::Timer study_timer(tile);")),
        (("#include <cuda_runtime.h>\n", "{prelude}"),
         (_ORDERED_TILE_LINE, _ORDERED_TILE_LINE + " study::Timer study_timer(tile);"))),
        "globaltimer at each block's start and end"),
    "heavy_first": (None, (
        (("#include <cuda_runtime.h>\n", "{prelude}"),
         (_TILE_LINE, "const int tile = study::g_order[blockIdx.x]; "
                      "study::Timer study_timer(tile);")),),
        "tiles launched in order of falling entry count, with the timeline"),
    "index_order": (None, (
        (("#include <cuda_runtime.h>\n", "{prelude}"),
         (_ORDERED_TILE_LINE, _TILE_LINE + " study::Timer study_timer(tile);")),),
        "tiles launched in index order, with the timeline"),
}

# The instrumentation of the timeline copies: a globaltimer stamp at each
# block's start and end, and an order in which blocks take tiles.
_STUDY_PRELUDE = r"""#include <cuda_runtime.h>
namespace study {
constexpr int kMaxTiles = 1 << 16;
__device__ unsigned long long g_span[2 * kMaxTiles];
__device__ int g_order[kMaxTiles];
__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct Timer {
  int tile;
  unsigned long long t0;
  __device__ explicit Timer(int t) : tile(t), t0(now()) {}
  __device__ ~Timer() {
    if (threadIdx.x == 0) {
      g_span[2 * tile] = t0;
      g_span[2 * tile + 1] = now();
    }
  }
};
}  // namespace study
extern "C" int study_read_spans(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, study::g_span, 16ull * n, 0,
                                               cudaMemcpyDeviceToDevice));
}
extern "C" int study_set_order(const void* src, int n) {
  return static_cast<int>(cudaMemcpyToSymbol(study::g_order, src, 4ull * n, 0,
                                             cudaMemcpyDeviceToDevice));
}
"""
_TIMED = ("+timeline", "+heavy_first", "+index_order")
SOURCES = ("composite_fwd", "composite_bwd")


def log(msg):
    print(msg, flush=True)


def substitute(text, alternatives):
    """`text` with the (old, new) pairs of the first alternative whose every
    old occurs exactly once, or None."""
    for pairs in alternatives:
        if all(text.count(old) == 1 for old, _ in pairs):
            for old, new in pairs:
                text = text.replace(old, new.replace("{prelude}", _STUDY_PRELUDE))
            return text
    return None


def variants(parent_dir):
    """[(label, source, text)] of everything to build: this tree's sources,
    the parent's, and each substitution that applies to either."""
    trees = [("", _build.CSRC_DIR)] + ([("parent", parent_dir)] if parent_dir else [])
    out = []
    for tag, directory in trees:
        for source in SOURCES:
            with open(os.path.join(directory, f"{source}.cu")) as f:
                text = f.read()
            base = f"{tag + ':' if tag else ''}{source}"
            out.append((base, source, text))
            for name, (src, alternatives, _) in ABLATIONS.items():
                if src in (None, source) and (copy := substitute(text, alternatives)):
                    out.append((f"{base}+{name}", source, copy))
    return out


# Launcher arguments that earlier designs lack: (the name that marks them in
# a source, the launchers that take them (None: every one), their
# positions). The tile order (the first design's launchers), the band's tile
# row offset (every design before the band viewport), and B3's ids and
# output width (every design before B3 summed per Gaussian; their per-entry
# output is the identity ids' one).
_LATER_ARGUMENTS = (("tile_order", None, (4,)), ("tile_row_offset", None, (7,)),
                    ("n_out", ("composite_bwd",), (12, 13)))


def _missing(source, text):
    """{launcher of ``source``: the positions of the arguments ``text`` lacks}."""
    out = {}
    for symbol, src in _build.SOURCE_OF.items():
        drop = {pos for name, symbols, positions in _LATER_ARGUMENTS
                if name not in text and (symbols is None or symbol in symbols)
                for pos in positions}
        if src == source and drop:
            out[symbol] = drop
    return out


class _Legacy:
    """A library built from a source whose launchers lack some arguments
    (``drop``: launcher -> positions): passes the wrapper's calls on without
    them."""

    def __init__(self, lib, drop):
        self._lib = lib
        self._drop = drop

    def __getattr__(self, symbol):
        fn = getattr(self._lib, symbol)
        if symbol not in self._drop:
            return fn
        drop = self._drop[symbol]
        return lambda *args: fn(*(a for i, a in enumerate(args) if i not in drop))


def build_all(items, directory):
    """Build every (label, source, text) at once; {label: (CDLL, ptxas usage)}."""
    jobs = {}
    missing = {label: _missing(source, text) for label, source, text in items}
    for i, (label, source, text) in enumerate(items):
        src = os.path.join(directory, f"v{i}_{source}.cu")
        lib = os.path.join(directory, f"libv{i}.so")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[label] = (source, proc, lib)
    built = {}
    for label, (source, proc, lib) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        cdll = _build.set_argtypes(ctypes.CDLL(lib), source)
        for fn in ("study_read_spans", "study_set_order"):
            if hasattr(cdll, fn):
                getattr(cdll, fn).argtypes = (ctypes.c_void_p, ctypes.c_int)
                getattr(cdll, fn).restype = ctypes.c_int
        if drop := missing[label]:
            for symbol, positions in drop.items():
                getattr(cdll, symbol).argtypes = tuple(
                    t for i, t in enumerate(_build.ARGTYPES[symbol]) if i not in positions)
            cdll = _Legacy(cdll, drop)
        built[label] = (cdll, _build.parse_ptxas(out))
    return built


def quantiles(x):
    x = x.double()
    return dict(mean=float(x.mean()), p50=float(x.quantile(0.5)),
                p99=float(x.quantile(0.99)), max=float(x.max()))


# Warp layouts: a warp covers WIDTH x (32 / WIDTH) pixels of the tile
# (tile_common.cuh's warp_box). 16 is the first design's two pixel rows.
LAYOUTS = {"rows": 16, "boxes": 8}


def _layout(width):
    """(the pixel of each thread [256], each warp's box (x, y, w, h))."""
    height = 32 // width
    pixel, boxes = [], []
    for warp in range(8):
        bx, by = (warp % (16 // width)) * width, (warp // (16 // width)) * height
        boxes.append((bx, by, width, height))
        pixel += [(by + lane // width) * 16 + bx + lane % width for lane in range(32)]
    return torch.tensor(pixel), boxes


def may_touch(e, x0, x1, y0, y1):
    """tile_common.cuh's may_touch in the same float32 arithmetic, per entry
    of e [10, K]: whether the entry can pass the gate at some pixel of the
    box [x0, x1] x [y0, y1] (each a float tensor [K] or a number)."""
    x, y, A, B, C, op = e[:6]
    det = (A.double() * C.double() - B.double() * B.double()).float()
    scale = (1.01 * 2.0 * torch.log(255.0 * op) + 0.01) / det
    reach_x, reach_y = torch.sqrt(scale * C) + 0.01, torch.sqrt(scale * A) + 0.01
    outside = ((x + reach_x < x0) | (x - reach_x > x1) | (y + reach_y < y0)
               | (y - reach_y > y1))
    return ~(op < 1.0 / 255.0) & (~(det > 0) | ~outside)


def work_counts(e, rs, re, tiles_x, latch):
    """Entries per tile, and the (warp, entry) visits of each walk, for each
    warp layout: every entry before the warp's last pixel's end, those where
    a lane contributes, and those that pass the warps' cull (may_touch in
    the same float arithmetic)."""
    from reduced_3dgs_torch import config
    n = (re - rs).long()
    start = rs.long()[:, None]
    lat = latch[..., 0].long()                                          # [T,256]
    scanned = (torch.minimum(lat + 1, re.long()[:, None]) - start).clamp(min=0)
    before = (lat - start).clamp(min=0)
    K = e.shape[1]
    seg = torch.repeat_interleave(torch.arange(rs.numel(), device=e.device), re - rs,
                                  output_size=K)
    pos = torch.arange(K, device=e.device)
    tile_x = ((seg % tiles_x) * config.BLOCK_X).float()
    tile_y = ((seg // tiles_x) * config.BLOCK_Y).float()
    x, y, A, B, C, op = e[:6]
    # The statistics form before the cull: every warp visits every entry of
    # each batch of 256 up to the one holding the block's last latch.
    batches = (scanned.amax(dim=1) + 255) // 256
    out = dict(tiles=int(n.numel()), empty_tiles=int((n == 0).sum()), entries=int(n.sum()),
               entries_per_tile=quantiles(n), entries_per_nonempty_tile=quantiles(n[n > 0]),
               fwd_scanned_pairs=int(scanned.sum()), bwd_pairs_before_latch=int(before.sum()),
               fwd_block_visits=int(scanned.amax(dim=1).sum()),
               bwd_warp_visits_block_start=int(8 * before.amax(dim=1).sum()),
               stats_warp_visits_every_entry=int(8 * torch.minimum(n, 256 * batches).sum()))
    for name, width in LAYOUTS.items():
        pixel, boxes = _layout(width)
        pixel = pixel.to(e.device)
        warps = lambda v: v[:, pixel].view(-1, 8, 32).amax(dim=2)           # [T,8]
        fwd_end = start[seg] + warps(scanned)[seg]                           # [K,8]
        bwd_end = start[seg] + warps(before)[seg]
        live_visits = culled_fwd = culled_bwd = 0
        for w, (bx, by, bw, bh) in enumerate(boxes):
            p = pixel[32 * w:32 * (w + 1)][:, None]
            dx = x - (tile_x + (p % config.BLOCK_X).float())
            dy = y - (tile_y + (p // config.BLOCK_X).float())
            power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
            alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=config.ALPHA_MAX)
            live = ((power <= 0.0) & (alpha >= config.ALPHA_EPS)
                    & (pos < lat[:, pixel[32 * w:32 * (w + 1)]].T[:, seg]))
            live_visits += int(live.any(dim=0).sum())
            x0, y0 = tile_x + bx, tile_y + by
            hit = may_touch(e, x0, x0 + bw - 1, y0, y0 + bh - 1)
            culled_fwd += int((hit & (pos < fwd_end[:, w])).sum())
            culled_bwd += int((hit & (pos < bwd_end[:, w])).sum())
        out.update({f"fwd_warp_visits_{name}": int(warps(scanned).sum()),
                    f"bwd_warp_visits_{name}": int(warps(before).sum()),
                    f"bwd_warp_visits_with_contributing_lane_{name}": live_visits,
                    f"fwd_warp_visits_after_cull_{name}": culled_fwd,
                    f"bwd_warp_visits_after_cull_{name}": culled_bwd,
                    # The statistics form walks as the forward form does.
                    f"stats_warp_visits_after_cull_{name}": culled_fwd})
    return out, scanned.sum(dim=1), before.sum(dim=1)


def timeline(lib, n_tiles, entries, work):
    """Spans of the last launch of a timeline copy: per-tile durations and how
    the blocks fill the kernel's span."""
    spans = torch.empty((n_tiles, 2), dtype=torch.int64, device="cuda")
    err = lib.study_read_spans(spans.data_ptr(), n_tiles)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"study_read_spans failed: CUDA error {err}")
    s = spans.cpu().double()
    t0, t1 = s[:, 0] - s[:, 0].min(), s[:, 1] - s[:, 0].min()
    dur = t1 - t0
    span = float(t1.max())
    # Blocks running at once: the largest number of open spans.
    ev = torch.cat([torch.stack([t0, torch.ones_like(t0)], 1),
                    torch.stack([t1, -torch.ones_like(t1)], 1)])
    ev = ev[torch.argsort(ev[:, 0] * 2 + (ev[:, 1] > 0).double(), stable=True)]
    concurrency = int(torch.cumsum(ev[:, 1], 0).max())
    ends = torch.sort(t1).values
    heavy = torch.argsort(dur, descending=True)[:5]

    def corr(a, b):
        a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
        return float((a * b).sum() / (a.norm() * b.norm() + 1e-30))

    return dict(
        span_us=span / 1e3, last_start_us=float(t0.max()) / 1e3,
        half_done_us=float(ends[len(ends) // 2]) / 1e3,
        ninety_done_us=float(ends[int(0.9 * (len(ends) - 1))]) / 1e3,
        max_concurrent_blocks=concurrency,
        block_us=quantiles(dur / 1e3), sum_block_us=float(dur.sum()) / 1e3,
        ideal_span_us=float(dur.sum()) / 1e3 / concurrency,
        heaviest=[dict(tile=int(i), us=float(dur[i]) / 1e3, entries=int(entries[i]),
                       start_us=float(t0[i]) / 1e3) for i in heavy],
        corr_us_entries=corr(dur, entries.cpu()), corr_us_work=corr(dur, work.cpu()))


def device_split(fn, calls=10):
    """Device time per call of each kernel fn launches, and the wall time per
    call, under torch.profiler."""
    import time
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    dev = {a.key[:48]: a.self_device_time_total / 1e3 / calls for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA}
    return dict(wall_ms=wall_ms, device_ms=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory with another composite_fwd.cu and "
                    "composite_bwd.cu to time in turns beside this tree's")
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_study: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from reduced_3dgs_torch.ops.rasterize import composite
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    card = cs.card_name()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"{card}; max SM clock {clock}")
    record = dict(card=card, max_sm_clock=clock)
    with tempfile.TemporaryDirectory() as tmp:
        items = variants(args.parent)
        built = build_all(items, tmp)
        record["ptxas"] = {label: usage for label, (_, usage) in built.items()}
        for label, (_, usage) in built.items():
            log(f"ptxas {label}: " + "; ".join(
                f"{k} {u['registers']} registers, {u['smem_bytes']} B smem, spills "
                f"{u['spill_stores']}/{u['spill_loads']} B" for k, u in usage.items()))

        dev = torch.device("cuda")
        params = cs.bench_scene(0)
        model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
        model_p = VariableSHGaussianModel(3, device=dev).load_numpy(cs.perturbed(params))
        pose = cs.view_poses()[0]
        cam = cs.view_camera(pose, dev)
        loss_cam = cs.view_camera(pose, dev, bg_color=cs.LOSS_BG)
        with torch.no_grad():
            e, rs, re, tiles_x, _, _ = cs.sorted_entries(model, cam)
            _, _, latch = composite.composite_fwd(e, rs, re, tiles_x)
            gt = torch.clamp(model(loss_cam)["render"], 0, 1)
            real = cs.loss_cotangents(model_p, loss_cam, gt)
        bwd_args = (*real["inputs"], real["final_t"], real["latch"], real["g_color4"],
                    real["g_t"])
        work, fwd_per_tile, _ = work_counts(e, rs, re, tiles_x, latch)
        bwd_work, _, bwd_per_tile = work_counts(*real["inputs"], real["latch"])
        per_tile = {"fwd": (re - rs, fwd_per_tile),
                    "bwd": (real["inputs"][2] - real["inputs"][1], bwd_per_tile)}
        record["work"] = dict(forward_camera=work, backward_camera=bwd_work)
        log(f"work, bench scene camera 0 (B1, B2): {json.dumps(work)}")
        log(f"work, perturbed scene camera 0 with the loss cotangents (B3): "
            f"{json.dumps(bwd_work)}")

        runs = {}  # label -> (kind, callable)
        for label, source, _ in items:
            lib = built[label][0]
            use = lambda name, lib=lib: lib

            def call(fn, args, use=use):
                saved = _build.load_library
                _build.load_library = use
                try:
                    return fn(*args)
                finally:
                    _build.load_library = saved

            if source == "composite_fwd":
                # Both forms run one walk, so a copy of it is timed as both;
                # the stats_ copies change the statistics form only.
                if "+stats_" not in label:
                    runs[f"{label} B1"] = ("fwd", lambda call=call: call(
                        composite.composite_fwd, (e, rs, re, tiles_x)))
                runs[f"{label} B2"] = ("stats", lambda call=call: call(
                    composite.composite_fwd_stats, (e, rs, re, tiles_x)))
            else:
                runs[f"{label} B3"] = ("bwd", lambda call=call: call(
                    composite.composite_bwd, bwd_args))

        # The first design's heaviest-first copies take tiles in the order of
        # falling entry count.
        for label, _, _ in items:
            if label.endswith("+heavy_first"):
                kind_tiles = (real["inputs"][2] - real["inputs"][1]
                              if label.split("+")[0].endswith("composite_bwd") else re - rs)
                order = torch.argsort(kind_tiles, descending=True, stable=True).int()
                err = built[label][0].study_set_order(order.data_ptr(), order.numel())
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"study_set_order failed: CUDA error {err}")

        def outputs(fn):
            with torch.no_grad():
                out = fn()
            torch.cuda.synchronize()
            return out if isinstance(out, tuple) else (out,)

        def same(a, b, kind):
            # B3 sums the warps' shares with shared-memory atomics, in an
            # order that varies from run to run.
            if kind != "bwd":
                return torch.equal(a, b)
            return bool(((a - b).abs().amax(dim=1) <= 1e-6 * b.abs().amax(dim=1)).all())

        for name, (kind, fn) in runs.items():
            label, what = name.split(" ")
            if label.endswith(_TIMED):
                real_out = outputs(runs[f"{label.split('+')[0]} {what}"][1])
                if not all(same(a, b, kind) for a, b in zip(outputs(fn), real_out)):
                    raise AssertionError(f"{name}: outputs differ from the real kernel's")

        times = {name: [] for name in runs}
        order = list(runs)
        with torch.no_grad():
            for rnd in range(2):
                for name in (order if rnd == 0 else order[::-1]):
                    times[name].append(cs.cuda_ms(runs[name][1]))
        record["times_ms"] = times
        for name in order:
            log(f"time {name}: {times[name][0]:.4f} ms, {times[name][1]:.4f} ms")

        record["timelines"] = {}
        for name, (kind, fn) in runs.items():
            label = name.split(" ")[0]
            if not label.endswith(_TIMED):
                continue
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            entries, w = per_tile["bwd" if kind == "bwd" else "fwd"]
            tl = timeline(built[label][0], entries.numel(), entries, w)
            record["timelines"][name] = tl
            log(f"timeline {name}: {json.dumps(tl)}")
        record["profiles"] = {}
        for name, (kind, fn) in runs.items():
            if "+" in name:
                continue
            prof = device_split(fn)
            record["profiles"][name] = prof
            log(f"profile {name}: {json.dumps(prof)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
