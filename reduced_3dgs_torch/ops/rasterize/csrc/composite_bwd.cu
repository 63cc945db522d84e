// Backward tile compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel
// (reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:502-652, launched by
// tile_composite_bwd, :655-717, from the custom VJP _cs_bwd, :794-806). See
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
// Design (the simple correct one): one thread block per 16x16 tile, one
// thread per pixel. The walk starts at the largest latch of the block (no
// entry at or after it contributes to any pixel, so those entries get zero)
// and goes down to range_start in batches of 64 entries staged through
// shared memory. Every thread visits every entry of the walk, contributing
// or not, so the warp shuffles and barriers are block-uniform. Each entry's
// ten partials are summed by a __shfl_xor_sync butterfly per warp (skipped
// when no lane of the warp contributes) and the eight warp sums are combined
// from shared memory after the batch. Each sorted entry belongs to exactly
// one tile, so one block writes each entry's gradients once: no atomics.
//
// Bound on the card: each (pixel, entry) pair before the pixel's latch costs
// about 13 float32 operations for the gate, and the pairs that pass it about
// 27 more for the gradients. At the 200k-Gaussian 544x976 bench scene that is
// 1.17e8 pairs, 2.1e7 of them passing: ~0.031 ms at the 67 TFLOP/s float32
// peak, against ~65 MB of bytes (~0.019 ms at 3.35 TB/s). The kernel is bound
// by operations, and in practice by the per-entry shuffle reductions and the
// sequential per-pixel walk (chip_smoke.py prints both counts and the bound).
// Left for a later change: fusing the per-Gaussian reduction into the kernel
// (an atomicAdd per entry), double-buffered staging, and fewer shuffles per
// entry (reduce several entries per butterfly).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kFields = 10;
constexpr int kBatch = 64;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ e, int K,
                     const int* __restrict__ range_start,
                     const int* __restrict__ range_end, int tiles_x,
                     const float* __restrict__ final_t,
                     const int* __restrict__ latch,
                     const float4* __restrict__ g_color4,
                     const float* __restrict__ g_t,
                     float* __restrict__ grads) {
  __shared__ float fields[kFields][kBatch];
  __shared__ float partial[kBatch][kFields][kWarps];
  __shared__ int walk_end;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = range_start[tile];
  const int end = range_end[tile];
  const int pix = tile * kPixels + tid;
  const int lat = latch[pix];
  const float4 g4 = g_color4[pix];
  float T = final_t[pix];
  float S = T * g_t[pix];

  if (tid == 0) walk_end = start;
  __syncthreads();
  atomicMax(&walk_end, lat);
  __syncthreads();
  const int stop = walk_end;

  // Entries at or after every pixel's latch receive no gradient.
  for (int idx = stop + tid; idx < end; idx += kPixels) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      grads[static_cast<size_t>(f) * K + idx] = 0.0f;
    }
  }

  for (int hi = stop; hi > start; hi -= kBatch) {
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    for (int i = tid; i < kFields * kBatch; i += kPixels) {
      const int f = i / kBatch;
      const int j = i % kBatch;
      if (j < n) fields[f][j] = e[static_cast<size_t>(f) * K + lo + j];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float g[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) g[f] = 0.0f;
      const float dx = fields[0][j] - px;
      const float dy = fields[1][j] - py;
      const float A = fields[2][j];
      const float B = fields[3][j];
      const float C = fields[4][j];
      const float op = fields[5][j];
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
        const float one_m = 1.0f - alpha;
        const float T_in = T / one_m;
        const float w = alpha * T_in;
        const float cdotg = fields[6][j] * g4.x + fields[7][j] * g4.y +
                            fields[8][j] * g4.z + fields[9][j] * g4.w;
        const float dabar = cdotg * T_in - S / one_m;
        const float dalpha = raw < kAlphaMax ? dabar : 0.0f;
        const float dpower = op * dalpha * G;
        g[0] = dpower * (-A * dx - B * dy);
        g[1] = dpower * (-C * dy - B * dx);
        g[2] = dpower * (-0.5f * dx * dx);
        g[3] = dpower * (-dx * dy);
        g[4] = dpower * (-0.5f * dy * dy);
        g[5] = G * dalpha;
        g[6] = w * g4.x;
        g[7] = w * g4.y;
        g[8] = w * g4.z;
        g[9] = w * g4.w;
        S += w * cdotg;
        T = T_in;
      }
      // Warp-uniform branch: every lane of the warp takes the same side.
      if (__any_sync(kFullMask, contrib)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          const float v = warp_sum(g[f]);
          if (lane == 0) partial[j][f][warp] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) partial[j][f][warp] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kFields; i += kPixels) {
      const int f = i / n;
      const int j = i % n;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[j][f][w];
      grads[static_cast<size_t>(f) * K + lo + j] = s;
    }
    // Barrier before the next batch overwrites fields and partial.
    __syncthreads();
  }
}

}  // namespace

// Launches the backward compositor on `stream` for `num_tiles` tiles and
// returns cudaGetLastError() (0 on success). e: float32 [10, K];
// range_start, range_end: int32 [num_tiles]; final_t: float32
// [num_tiles, 256]; latch: int32 [num_tiles, 256] (the forward kernel's);
// g_color4: float32 [num_tiles, 256, 4]; g_t: float32 [num_tiles, 256];
// grads: float32 [10, K], every entry written.
extern "C" int composite_bwd(const float* e, int K, const int* range_start,
                             const int* range_end, int num_tiles, int tiles_x,
                             const float* final_t, const int* latch,
                             const float* g_color4, const float* g_t,
                             float* grads, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_bwd_kernel<<<num_tiles, kPixels, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      e, K, range_start, range_end, tiles_x, final_t, latch,
      reinterpret_cast<const float4*>(g_color4), g_t, grads);
  return static_cast<int>(cudaGetLastError());
}
