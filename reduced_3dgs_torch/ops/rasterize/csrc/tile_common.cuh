// Shared by composite_fwd.cu and composite_bwd.cu: the order in which the
// compositors' blocks take tiles, and the test by which a warp skips the
// entries that none of its pixels can blend.
#pragma once

#include <cuda_runtime.h>

namespace tile_common {

constexpr int kOrderThreads = 1024;
constexpr int kOrderBuckets = 128;
// The compositors' gate: an entry blends only where alpha >= kAlphaEps.
constexpr float kAlphaEps = 1.0f / 255.0f;

// A tile's bucket by its entry count n: 0 for an empty tile, else
// 1 + 4 floor(log2 n) + the two bits below n's leading one (four buckets per
// doubling, up to 124 for n < 2^31). Longer tiles have larger buckets.
__device__ __forceinline__ int order_bucket(int n) {
  if (n <= 0) return 0;
  const int l = 31 - __clz(n);
  const int frac = l >= 2 ? (n >> (l - 2)) & 3 : (n << (2 - l)) & 3;
  return 1 + 4 * l + frac;
}

// Adds one to slot[b] for every lane of the warp (all lanes call it; b < 0
// adds nothing) and returns the lane's count before its own addition: one
// shared atomic per distinct bucket in the warp, since many tiles share one.
__device__ __forceinline__ int warp_slot_add(int* slot, int b) {
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && b >= 0) base = atomicAdd(&slot[b], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// tile_order: int32 [num_tiles], the tiles by falling bucket, a counting sort
// in one block (the order within a bucket varies from run to run). Block i of
// a compositor takes tile tile_order[i], so the longest tiles start first
// and none is left to run alone at the end of the launch.
__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(const int* __restrict__ range_start,
                  const int* __restrict__ range_end, int num_tiles,
                  int* __restrict__ tile_order) {
  __shared__ int slot[kOrderBuckets];
  for (int b = threadIdx.x; b < kOrderBuckets; b += kOrderThreads) slot[b] = 0;
  __syncthreads();
  // Every lane runs every round, so the warp-wide calls see the whole warp.
  for (int t0 = 0; t0 < num_tiles; t0 += kOrderThreads) {
    const int t = t0 + threadIdx.x;
    warp_slot_add(slot, t < num_tiles ? order_bucket(range_end[t] - range_start[t]) : -1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int next = 0;
    for (int b = kOrderBuckets - 1; b >= 0; --b) {
      const int count = slot[b];
      slot[b] = next;
      next += count;
    }
  }
  __syncthreads();
  for (int t0 = 0; t0 < num_tiles; t0 += kOrderThreads) {
    const int t = t0 + threadIdx.x;
    const int b = t < num_tiles ? order_bucket(range_end[t] - range_start[t]) : -1;
    const int at = warp_slot_add(slot, b);
    if (b >= 0) tile_order[at] = t;
  }
}

// Launches tile_order_kernel on `stream`; returns cudaGetLastError().
inline int launch_tile_order(const int* range_start, const int* range_end,
                             int num_tiles, int* tile_order, cudaStream_t stream) {
  tile_order_kernel<<<1, kOrderThreads, 0, stream>>>(range_start, range_end, num_tiles,
                                                     tile_order);
  return static_cast<int>(cudaGetLastError());
}

// The pixel a thread of a 16x16 tile's block composites, and the box of
// pixels its warp covers: warp w covers a kWarpWidth x (32 / kWarpWidth)
// box, the boxes in row-major order over the tile and the lanes in
// row-major order within the box. (kWarpWidth = 16 gives thread t pixel t.)
// Tile ids are local to a band of tile rows that starts tile_row_offset rows
// down the image (0 for the whole image), so a pixel has the same position
// in a band as in the full render.
struct WarpBox {
  int pixel;       // the thread's pixel, row-major in the tile
  float px, py;    // its position
  float x0, x1;    // the warp's first and last column
  float y0, y1;    // the warp's first and last row
};

template <int kWarpWidth>
__device__ __forceinline__ WarpBox warp_box(int tile, int tiles_x, int tile_row_offset,
                                            int tid) {
  constexpr int kTile = 16;
  constexpr int kWarpHeight = 32 / kWarpWidth;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bx = (warp % (kTile / kWarpWidth)) * kWarpWidth;
  const int by = (warp / (kTile / kWarpWidth)) * kWarpHeight;
  const int lx = bx + lane % kWarpWidth;
  const int ly = by + lane / kWarpWidth;
  const int tx = (tile % tiles_x) * kTile;
  const int ty = (tile / tiles_x + tile_row_offset) * kTile;
  WarpBox box;
  box.pixel = ly * kTile + lx;
  box.px = static_cast<float>(tx + lx);
  box.py = static_cast<float>(ty + ly);
  box.x0 = static_cast<float>(tx + bx);
  box.x1 = static_cast<float>(tx + bx + kWarpWidth - 1);
  box.y0 = static_cast<float>(ty + by);
  box.y1 = static_cast<float>(ty + by + kWarpHeight - 1);
  return box;
}

// Whether the staged entry q0 = (x, y, A, B), q1 = (C, op, ...) can pass the
// compositors' gate (power <= 0 and min(0.99, op e^power) >= 1/255) at some
// pixel (px, py) with px in [x0, x1] and py in [y0, y1]. It can only where
// op >= 1/255 and d^T M d <= tau = 2 ln(255 op), d = (x - px, y - py),
// M = [[A, B], [B, C]]: an ellipse whose bounding box reaches
// sqrt(tau C / det M) along x and sqrt(tau A / det M) along y. The box is
// widened (tau by 1% plus 0.01, the reach by 0.01 px) to cover the gate's
// float rounding, and a NaN or infinity in the box's arithmetic, or
// det M <= 0, answers true, so the answer is false only where no pixel of
// the box can blend the entry.
__device__ __forceinline__ bool may_touch(float4 q0, float4 q1, float x0, float x1,
                                          float y0, float y1) {
  const float op = q1.y;
  if (op < kAlphaEps) return false;
  const float det = static_cast<float>(static_cast<double>(q0.z) * q1.x -
                                       static_cast<double>(q0.w) * q0.w);
  if (!(det > 0.0f)) return true;
  const float scale = (1.01f * 2.0f * logf(255.0f * op) + 0.01f) / det;
  const float reach_x = sqrtf(scale * q1.x) + 0.01f;
  const float reach_y = sqrtf(scale * q0.z) + 0.01f;
  return !(q0.x + reach_x < x0 || q0.x - reach_x > x1 || q0.y + reach_y < y0 ||
           q0.y - reach_y > y1);
}

}  // namespace tile_common
