// Backward tile compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel
// (reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:502-652, launched by
// tile_composite_bwd, :655-717, from the custom VJP _cs_bwd, :794-806), and
// the per-Gaussian sum of its per-entry output. See
// reduced_3dgs_torch/ops/rasterize/composite.py for the contract and for
// composite_bwd_plain, the plain PyTorch version (autograd through the
// forward) this kernel is held against.
//
// Per pixel, back to front over the entries the forward compositor let
// contribute (gated, and at a sorted position below the pixel's latch):
//   T_in  = T / (1 - a)                 (T starts at final_T)
//   da    = (c . g) T_in - S / (1 - a)  (S starts at final_T g_T and then
//                                        sums w (c . g) of later entries)
//   dalpha = da where op G < 0.99, else 0 (the clamp's subgradient)
//   dpower = op dalpha G
// and per entry the ten gradients, summed over the tile's pixels:
//   d(x, y)  = dpower (-A dx - B dy, -C dy - B dx)
//   d(A,B,C) = dpower (-dx^2 / 2, -dx dy, -dy^2 / 2)
//   d op     = G dalpha
//   d(r,g,b,depth) = w g_color
// with dx = x - px, dy = y - py and power = -(A dx^2 + C dy^2) / 2 - B dx dy.
//
// What bounds it on this card. The work is ~13 float32 operations for the
// gate on each (pixel, entry) pair before the pixel's latch and ~27 more on
// the pairs that pass it: at the 200k-Gaussian 544x976 bench scene 1.17e8
// and 2.1e7 pairs, ~0.031 ms at the 67 TFLOP/s float32 peak (~65 MB take
// ~0.019 ms at 3.35 TB/s). Every lane of a warp reads the same staged entry,
// so the kernel's time follows its (warp, entry) visits and what each costs.
// The first design (one block-wide walk over 4.9e6 visits; per visit ten
// scalar shared loads, ten stores and, where a lane contributed, a 5-step
// butterfly per field; tiles in index order) took 0.90 ms, and its
// ablations split it (kernel_study.py; NVIDIA H100 80GB HBM3, 700 W): ten
// more loads per visit +0.21 ms, the shuffles removed -0.16 ms, tiles
// launched longest first -0.11 ms (a tile's time follows its entry count,
// correlation 0.96, and the longest ones started late). With entry-major
// staging, the reduce-scatter below, a per-warp start and the tile order,
// the shuffles no longer count: what is left is the instructions each
// visit issues. So the design also cuts the visits: 1.76e6 remain, 81% of
// them with a contributing lane, at ~0.40 ms of device time (~59 SM clocks
// per visit: the gate, exp, two divisions and the reduce-scatter, each a
// dependent chain). Its ablations (same tool and card): no cull +0.19 to
// +0.23 ms, warps of two pixel rows instead of 8 x 4 +0.08 to +0.12 ms,
// tiles in index order +0.05 to +0.08 ms, no copy overlap +0.02 to
// +0.03 ms; the shuffles removed, one reciprocal for the two divisions,
// batches of 256, groups of 2 or 3 entries and a cap of 48 registers each
// move it by less than the noise between two timings (~0.03 ms).
//
// Design. One block per 16x16 tile, one thread per pixel; blocks take tiles
// longest first (tile_common.cuh's order kernel, launched before this one,
// fills tile_order). A warp covers an 8 x 4 box of pixels. Each entry is
// staged as 12 floats, the ten fields and two of padding, so a lane reads it
// with three 128-bit broadcast loads (the colour one only when a lane
// contributes). Batches of kBatch entries are double-buffered with cp.async:
// the next batch loads while this one is walked, one barrier per batch.
// Each warp starts at its own largest latch (__reduce_max_sync), not the
// block's. It takes its entries 32 at a time: each lane tests one entry's
// ellipse against the warp's box (tile_common::may_touch, conservative) and
// a ballot leaves the entries some pixel of the box may blend, which the
// warp then visits back to front. A visit's ten per-pixel partials are
// summed by a reduce-scatter: each shuffle step halves the values a lane
// keeps, so after 5 + 3 + 2 + 1 + 1 = 12 shuffles (instead of 50) each
// value's warp sum sits in one owner lane, which adds it to the batch's
// sums in shared memory (a float atomicAdd; eight warps add to each entry).
// After the next barrier the batch's sums are added into the gradient of
// each entry's Gaussian: entry i's ten sums go to column ids[i] of grads
// [10, n_out], one global float atomic (a reduction, no value returned) per
// sum that is not zero. No Gaussian has two entries in one tile, so each
// carries a whole (tile, Gaussian) sum. Entries at or after every pixel's
// latch, and a static buffer's tail, are never read or written. The order
// of the shared and global additions varies, so the last bits of a gradient
// may vary from run to run. Given the identity ids and n_out = K, the
// kernel gives the per-entry gradients, each sum added onto a zero.
//
// The output's layout was chosen by timing two (kernel_study.py's method:
// median of 20 CUDA-event timings, two rounds; profiler device time; the
// flagship scene, 1.25M Gaussians at 979 x 546, two views, the static
// buffer of 10,380,288 and the exact one of 8.84-8.87M entries; NVIDIA H100
// 80GB HBM3, 700 W). The per-entry design before it with PyTorch's
// index_add_: 4.14-4.27 ms (the kernel 2.81-2.86 ms of device time, the
// index_add_ 1.24-1.31). Scalar atomics into [10, N], the layout the
// preprocess backward reads: 2.83-2.94 ms (the kernel 2.78-2.81). float4 and
// float2 atomics into [N, 12] rows, three an entry, then an unpack kernel to
// [10, N]: 2.83-2.95 ms (the kernel 2.75-2.77, the unpack 0.036). The
// scalar form is the choice: the same time, no second kernel or launch, and
// 50 MB of output against 110 MB (the per-entry design's 404-465 MB).
//
// kGroup entries could share one reduce-scatter (10 kGroup values over 32
// lanes: 12 shuffles per entry for 1, 10.5 for 2, 10 for 3). 1 is the
// choice: 62 registers (59 since the per-Gaussian sum) and no spills,
// against 78 registers for 2 and 80 with 16 B of spills for 3, and neither
// is faster (kernel_study.py).
//
// Left for a later change: the gather e = fields10[:, s_gidx] fused into
// the staging, and fewer instructions per visit.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kFields = 10;
constexpr int kStride = 12;  // floats per staged entry: three float4
constexpr int kWarpWidth = 8;  // a warp covers 8 x 4 pixels of the tile
constexpr int kBatch = 128;
constexpr int kGroup = 1;  // entries per reduce-scatter
constexpr int kValues = kGroup * kFields;
constexpr unsigned kFullMask = 0xffffffffu;
using tile_common::kAlphaEps;
constexpr float kAlphaMax = 0.99f;

// Reduce-scatter of the first N values of v over the warp's lanes, shuffle
// distances kOffset, kOffset / 2, ..., 1. Each step keeps half of a lane's
// values (the upper half on lanes whose kOffset bit is set, padded with a
// zero when N is odd) and adds the partner's copy of that half; once one
// value is left, the remaining steps add it whole. Afterwards v[0] holds the
// warp sum of value value_slot(lane).
template <int N, int kOffset>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (kOffset > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(kFullMask, v[0], kOffset);
      reduce_scatter<1, kOffset / 2>(v, lane);
    } else {
      constexpr int kHalf = (N + 1) / 2;
      const bool upper = lane & kOffset;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float lo = v[i];
        const float hi = i + kHalf < N ? v[i + kHalf] : 0.0f;
        v[i] = (upper ? hi : lo) + __shfl_xor_sync(kFullMask, upper ? lo : hi, kOffset);
      }
      reduce_scatter<kHalf, kOffset / 2>(v, lane);
    }
  }
}

// The value whose warp sum `lane` holds after reduce_scatter<kValues, 16>,
// and whether the lane stores it: of the lanes that hold one value (the
// steps after a single value is left give it to several), the lowest one;
// lanes that end on a padding slot store nothing.
__device__ __forceinline__ int value_slot(int lane, bool& owner) {
  int n = kValues, slot = 0, real = kValues;
  owner = true;
  for (int offset = 16; offset > 0; offset >>= 1) {
    if (n == 1) {
      owner = owner && !(lane & offset);
      continue;
    }
    const int half = (n + 1) / 2;
    if (lane & offset) {
      slot += half;
      real -= half;
    } else {
      real = min(real, half);
    }
    n = half;
  }
  owner = owner && real > 0;
  return slot;
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ e, int K,
                     const int* __restrict__ range_start,
                     const int* __restrict__ tile_order, int tiles_x,
                     int tile_row_offset,
                     const float* __restrict__ final_t,
                     const int* __restrict__ latch,
                     const float4* __restrict__ g_color4,
                     const float* __restrict__ g_t,
                     const long long* __restrict__ ids, int n_out,
                     float* __restrict__ grads) {
  __shared__ __align__(16) float stage[2][kBatch * kStride];
  // Per batch, the tile's sums of each entry's ten gradients.
  __shared__ float sums[2][kBatch * kFields];
  __shared__ int warp_stop[kWarps];
  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const tile_common::WarpBox box = tile_common::warp_box<kWarpWidth>(
      tile, tiles_x, tile_row_offset, tid);
  const float px = box.px;
  const float py = box.py;
  const int start = range_start[tile];
  const int pix = tile * kPixels + box.pixel;
  const int lat = latch[pix];
  const float4 g4 = g_color4[pix];
  float T = final_t[pix];
  float S = T * g_t[pix];
  bool owner;
  const int slot = value_slot(lane, owner);
  const int slot_entry = slot / kFields;
  const int slot_field = slot % kFields;

  // Each warp walks down from its own largest latch, the block from the
  // largest of those.
  const int my_stop = __reduce_max_sync(kFullMask, lat);
  if (lane == 0) warp_stop[warp] = my_stop;
  for (int i = tid; i < 2 * kBatch * kFields; i += kPixels) (&sums[0][0])[i] = 0.0f;
  __syncthreads();
  int stop = start;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) stop = max(stop, warp_stop[w]);

  // Batch b holds entries [max(start, hi - kBatch), hi), hi = stop - b kBatch.
  auto stage_batch = [&](int hi, int buf) {
    const int lo = max(start, hi - kBatch);
    for (int i = tid; i < kFields * kBatch; i += kPixels) {
      const int f = i / kBatch;
      const int j = i % kBatch;
      if (lo + j < hi) {
        __pipeline_memcpy_async(&stage[buf][j * kStride + f],
                                &e[static_cast<size_t>(f) * K + lo + j], sizeof(float));
      }
    }
    __pipeline_commit();
  };
  // Batch b's sums, from sums[buf], added into the gradient of each entry's
  // Gaussian (a global float atomic per nonzero sum); sums[buf] back to zero.
  auto write_batch = [&](int b, int buf) {
    const int hi = stop - b * kBatch;
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    for (int i = tid; i < n * kFields; i += kPixels) {
      const int f = i / n;
      const int j = i % n;
      const float v = sums[buf][j * kFields + f];
      if (v != 0.0f) atomicAdd(&grads[static_cast<size_t>(f) * n_out + ids[lo + j]], v);
      sums[buf][j * kFields + f] = 0.0f;
    }
  };

  const int batches = (stop - start + kBatch - 1) / kBatch;
  if (batches > 0) stage_batch(stop, 0);
  for (int b = 0;; ++b) {
    const int buf = b & 1;
    // Batch b is staged, every warp has added its sums of batch b - 1, and
    // nobody reads the buffers the next steps overwrite.
    __pipeline_wait_prior(0);
    __syncthreads();
    if (b > 0) write_batch(b - 1, buf ^ 1);
    if (b == batches) break;
    const int hi = stop - b * kBatch;
    const int lo = max(start, hi - kBatch);
    if (b + 1 < batches) stage_batch(hi - kBatch, buf ^ 1);
    const float* batch = stage[buf];
    float* part = sums[buf];
    // This warp's entries in the batch: [lo, lo + jtop), warp-uniform,
    // taken 32 at a time: lane k tests entry j0 - k against the warp's box
    // of pixels, and the warp visits, back to front, the entries some pixel
    // there can blend.
    const int jtop = min(hi, my_stop) - lo;
    for (int j0 = jtop - 1; j0 >= 0; j0 -= 32) {
      const int jl = j0 - lane;
      bool hit = false;
      if (jl >= 0) {
        const float4* q = reinterpret_cast<const float4*>(batch + jl * kStride);
        hit = tile_common::may_touch(q[0], q[1], box.x0, box.x1, box.y0, box.y1);
      }
      unsigned bits = __ballot_sync(kFullMask, hit);
      while (bits) {
        float v[kValues];
        int jg[kGroup];
        bool any = false;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float* vg = v + g * kFields;
#pragma unroll
          for (int f = 0; f < kFields; ++f) vg[f] = 0.0f;
          jg[g] = -1;
          if (!bits) continue;
          const int j = j0 - (__ffs(bits) - 1);
          bits &= bits - 1;
          jg[g] = j;
          const float4* q = reinterpret_cast<const float4*>(batch + j * kStride);
          const float4 q0 = q[0];  // x, y, A, B
          const float4 q1 = q[1];  // C, op, r, g
          const float dx = q0.x - px;
          const float dy = q0.y - py;
          const float A = q0.z;
          const float B = q0.w;
          const float C = q1.x;
          const float op = q1.y;
          const float power = -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
          // Gate before exp: a gated-out entry may have power > 0.
          bool contrib = (lo + j < lat) && power <= 0.0f;
          float G = 0.0f, raw = 0.0f, alpha = 0.0f;
          if (contrib) {
            G = expf(power);
            raw = op * G;
            alpha = fminf(kAlphaMax, raw);
            contrib = alpha >= kAlphaEps;
          }
          if (contrib) {
            const float4 q2 = q[2];  // b, depth, padding
            const float one_m = 1.0f - alpha;
            const float T_in = T / one_m;
            const float w = alpha * T_in;
            const float cdotg = q1.z * g4.x + q1.w * g4.y + q2.x * g4.z + q2.y * g4.w;
            const float dabar = cdotg * T_in - S / one_m;
            const float dalpha = raw < kAlphaMax ? dabar : 0.0f;
            const float dpower = op * dalpha * G;
            vg[0] = dpower * (-A * dx - B * dy);
            vg[1] = dpower * (-C * dy - B * dx);
            vg[2] = dpower * (-0.5f * dx * dx);
            vg[3] = dpower * (-dx * dy);
            vg[4] = dpower * (-0.5f * dy * dy);
            vg[5] = G * dalpha;
            vg[6] = w * g4.x;
            vg[7] = w * g4.y;
            vg[8] = w * g4.z;
            vg[9] = w * g4.w;
            S += w * cdotg;
            T = T_in;
            any = true;
          }
        }
        // The entry whose sum this lane holds, and whether it stores it.
        int je = -1;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (g == slot_entry) je = jg[g];
        }
        const bool store = owner && je >= 0;
        // Warp-uniform branch: every lane of the warp takes the same side.
        if (__any_sync(kFullMask, any)) {
          reduce_scatter<kValues, 16>(v, lane);
          if (store) atomicAdd(&part[je * kFields + slot_field], v[0]);
        }
      }
    }
  }
}

}  // namespace

// Launches the backward compositor on `stream` for `num_tiles` tiles and
// returns cudaGetLastError() (0 on success). e: float32 [10, K];
// range_start, range_end: int32 [num_tiles]; tile_order: int32 [num_tiles],
// scratch that the launch fills with the tiles, longest first (block i
// composites tile tile_order[i]); tiles_x and tile_row_offset: as for
// composite_fwd; final_t: float32 [num_tiles, 256]; latch:
// int32 [num_tiles, 256] (the forward kernel's); g_color4: float32
// [num_tiles, 256, 4]; g_t: float32 [num_tiles, 256]; ids: int64 [K], the
// column of grads that each sorted entry's gradient is added into, read only
// for the entries in a tile's range; grads: float32 [10, n_out], zeroed by
// the caller, to which the launch adds.
extern "C" int composite_bwd(const float* e, int K, const int* range_start,
                             const int* range_end, int* tile_order,
                             int num_tiles, int tiles_x, int tile_row_offset,
                             const float* final_t, const int* latch,
                             const float* g_color4, const float* g_t,
                             const long long* ids, int n_out, float* grads,
                             void* stream) {
  if (num_tiles <= 0) return 0;
  const int err = tile_common::launch_tile_order(
      range_start, range_end, num_tiles, tile_order, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  composite_bwd_kernel<<<num_tiles, kPixels, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      e, K, range_start, tile_order, tiles_x, tile_row_offset, final_t, latch,
      reinterpret_cast<const float4*>(g_color4), g_t, ids, n_out, grads);
  return static_cast<int>(cudaGetLastError());
}
