// Forward tile compositor for NVIDIA Hopper (sm_90a), with and without the
// per-entry statistics.
//
// Replaces the Pallas TPU kernel _fwd_kernel
// (reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300-423, launched by
// tile_composite_fwd, :426-495): composite_fwd is its with_stats=False form
// (B1), composite_fwd_stats its with_stats=True form (B2, :329-332, :393-401,
// :457-463, :489-495). The function is the forward pass of the CUDA 3DGS
// rasterizer that the Pallas kernel was itself modelled on; see
// reduced_3dgs_torch/ops/rasterize/composite.py for the contract and for
// composite_fwd_plain and composite_fwd_stats_plain, the plain PyTorch
// versions these kernels are held against.
//
// What bounds it on this card. Each (pixel, entry) pair scanned costs ~13
// float32 operations (offsets, quadratic form, exp, gates) plus ~10 more when
// it contributes: at the 200k-Gaussian 544x976 bench scene (K ~ 0.6M
// entries, 1.18e8 pairs scanned) ~0.023 ms at the 67 TFLOP/s float32 peak,
// while the bytes (entries 40 B each, outputs 24 B per pixel, ~37 MB; 16 B
// per entry more for the statistics) take ~0.011 ms at 3.35 TB/s. Every lane
// of a warp reads the same staged entry, so the time follows the (warp,
// entry) visits. The first design (4.5e6 visits of ten scalar shared loads
// each, entries staged field by field one batch at a time, tiles in index
// order) took 0.37 ms, and its ablations split it (kernel_study.py; NVIDIA
// H100 80GB HBM3, 700 W): ten more loads per visit +0.165 ms, so the loads
// took about 0.17 ms; tiles launched longest first -0.05 to -0.07 ms; the
// gate with FMA allowed and the four colour loads removed within the noise.
// This design cuts both: three 128-bit loads per visit and 1.77e6 visits
// after the warps' cull, ~0.14 ms of device time. Its ablations (same tool
// and card): no cull +0.15 to +0.17 ms, warps of two pixel rows +0.03 to
// +0.04 ms, tiles in index order +0.03 to +0.04 ms; FMA in the gate, no
// copy overlap and a cap of 32 registers within the noise. The longest
// tiles now set the span: each takes ~130 us of the kernel's ~140 us.
//
// Design. One thread block per 16x16 tile, one thread per pixel; blocks
// take tiles longest first (tile_common.cuh's order kernel, launched before
// this one, fills tile_order). The block walks its tile's sorted entries
// [range_start[t], range_end[t]) in batches of 256, each entry staged as 12
// floats (the ten fields, two of padding), so a lane reads an entry with
// three 128-bit broadcast loads (the colour one only when it blends).
// Batches are double-buffered with cp.async: each thread copies one entry of
// the next batch while the block walks this one, with one barrier per batch.
// A warp covers an 8 x 4 box of pixels and takes the batch 32 entries at a
// time: each lane tests one entry's ellipse against the box
// (tile_common::may_touch, conservative), and the warp's pixels blend, front
// to back, the entries a ballot keeps, with T, the colour and depth sums
// and the latch in registers; a pixel stops at its latch, a warp when all
// of its pixels have. Once every pixel of the block has latched,
// __syncthreads_count ends the walk. Threads of pixels outside the image
// stay in the loop, so every thread reaches every barrier; they also count
// in the statistics, as in the JAX package (its pixel grid has no in-image
// mask). The gate's quadratic form is rounded op by op in the plain
// version's order, so that the statistics' counts equal the plain
// version's.
//
// Statistics (kWithStats): for each sorted entry, over the tile's pixels
// where it contributes (gated and before the pixel's latch), the count, the
// count times the entry's opacity (summed as op per pixel), the sum of the
// blend weights w = alpha T_in and the sum of the incoming transmittance. Each
// thread then visits every entry of the batch, latched or not, so that the
// per-entry sums are warp-uniform: a __shfl_xor_sync butterfly per statistic
// (skipped when __any_sync finds no contributing lane), the eight warp sums
// combined from shared memory after the batch (4 x 8 floats per entry, 32 KB
// per batch, dynamic shared memory beside the 24 KB of staging). Each sorted
// entry belongs to one tile, so one block writes its statistics once: no
// atomics. Entries the walk never reaches (past the block-wide exit) are
// written as zeros. Both forms blend through the same inlined function, so
// their colour, T and latch are the same bits.
//
// The statistics form shares the staging, the tile order and the warps'
// boxes (a warp's sums run over its 32 pixels wherever they lie), not the
// cull: each of its warps visits every entry of the batch.
//
// Left for a later change: the statistics' butterflies as a reduce-scatter
// and the warps' cull (as in composite_bwd.cu), and fusing the gather
// e = fields10[:, s_gidx] into the staging.
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
constexpr int kStats = 4;
constexpr int kStatsBytes = kPixels * kStats * kWarps * sizeof(float);
constexpr unsigned kFullMask = 0xffffffffu;
using tile_common::kAlphaEps;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

enum Blend { kSkip, kContrib, kLatch };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// Blends the staged entry q (x y A B | C op r g | b depth - -) into the
// pixel (px, py). Returns kSkip when the entry is gated out, kLatch when it
// would take T below 1e-4 (it is excluded and the pixel is done), and
// kContrib otherwise, with the colour, depth and T updated and w = alpha T_in.
__device__ __forceinline__ Blend blend(const float4* q, float px, float py,
                                       float& T, float& cr, float& cg,
                                       float& cb, float& cd, float& w) {
  const float4 q0 = q[0];
  const float4 q1 = q[1];
  const float dx = q0.x - px;
  const float dy = q0.y - py;
  // -0.5 (A dx^2 + C dy^2) - B dx dy with every product and sum rounded on
  // its own (no FMA contraction), in the plain version's order: the gates
  // then decide exactly as the plain version's do, and the statistics'
  // counts are compared exactly.
  const float power = __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(q0.z, dx), dx),
                                 __fmul_rn(__fmul_rn(q1.x, dy), dy))),
      __fmul_rn(__fmul_rn(q0.w, dx), dy));
  if (power > 0.0f) return kSkip;
  const float alpha = fminf(kAlphaMax, q1.y * expf(power));
  if (alpha < kAlphaEps) return kSkip;
  const float test_t = T * (1.0f - alpha);
  if (test_t < kTEps) return kLatch;
  const float4 q2 = q[2];
  w = alpha * T;
  cr += w * q1.z;
  cg += w * q1.w;
  cb += w * q2.x;
  cd += w * q2.y;
  T = test_t;
  return kContrib;
}

template <bool kWithStats>
__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ e, int K,
                     const int* __restrict__ range_start,
                     const int* __restrict__ range_end,
                     const int* __restrict__ tile_order, int tiles_x,
                     float4* __restrict__ color4, float* __restrict__ final_t,
                     int* __restrict__ latch, float* __restrict__ stats) {
  __shared__ __align__(16) float stage[2][kPixels * kStride];
  // kWithStats: per entry of the batch, statistic and warp, [kPixels][kStats][kWarps].
  extern __shared__ float partial[];
  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const tile_common::WarpBox box = tile_common::warp_box<kWarpWidth>(tile, tiles_x, tid);
  const float px = box.px;
  const float py = box.py;
  const int start = range_start[tile];
  const int end = range_end[tile];

  // Thread tid copies entry base + tid's ten fields into stage[buf].
  auto stage_batch = [&](int base, int buf) {
    const int idx = base + tid;
    if (idx < end) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        __pipeline_memcpy_async(&stage[buf][tid * kStride + f],
                                &e[static_cast<size_t>(f) * K + idx], sizeof(float));
      }
    }
    __pipeline_commit();
  };

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int lat = end;  // no latch
  int done = 0;
  int base = start;
  int buf = 0;
  if (start < end) stage_batch(start, 0);
  for (; base < end; base += kPixels, buf ^= 1) {
    // The batch at `base` is staged, nobody reads the other buffer any more,
    // and the block-wide exit.
    __pipeline_wait_prior(0);
    if (__syncthreads_count(done) == kPixels) break;
    if (base + kPixels < end) stage_batch(base + kPixels, buf ^ 1);
    const int n = min(kPixels, end - base);
    const float4* batch = reinterpret_cast<const float4*>(stage[buf]);
    if constexpr (!kWithStats) {
      // 32 entries at a time: lane k tests entry j0 + k against the warp's
      // box of pixels, and the warp's pixels that have not latched blend
      // the entries some pixel there can blend, front to back.
      for (int j0 = 0; j0 < n && !__all_sync(kFullMask, done); j0 += 32) {
        const int jl = j0 + lane;
        const float4* ql = batch + 3 * jl;
        const bool hit =
            jl < n && tile_common::may_touch(ql[0], ql[1], box.x0, box.x1, box.y0, box.y1);
        for (unsigned bits = __ballot_sync(kFullMask, hit); bits; bits &= bits - 1) {
          const int j = j0 + __ffs(bits) - 1;
          float w;
          if (!done && blend(batch + 3 * j, px, py, T, cr, cg, cb, cd, w) == kLatch) {
            lat = base + j;  // the latching entry is excluded too
            done = 1;
          }
        }
      }
    } else {
      for (int j = 0; j < n; ++j) {
        const float4* q = batch + 3 * j;
        float v[kStats] = {0.0f, 0.0f, 0.0f, 0.0f};
        bool contrib = false;
        if (!done) {
          const float T_in = T;
          float w = 0.0f;
          const Blend b = blend(q, px, py, T, cr, cg, cb, cd, w);
          if (b == kLatch) {
            lat = base + j;
            done = 1;
          }
          contrib = b == kContrib;
          if (contrib) {
            v[0] = 1.0f;
            v[1] = q[1].y;  // opacity
            v[2] = w;
            v[3] = T_in;
          }
        }
        // Warp-uniform branch: every lane of the warp takes the same side.
        if (__any_sync(kFullMask, contrib)) {
#pragma unroll
          for (int s = 0; s < kStats; ++s) {
            const float sum = warp_sum(v[s]);
            if (lane == 0) partial[(j * kStats + s) * kWarps + warp] = sum;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int s = 0; s < kStats; ++s) partial[(j * kStats + s) * kWarps + warp] = 0.0f;
        }
      }
      __syncthreads();
      for (int i = tid; i < n * kStats; i += kPixels) {
        const int s = i / n;
        const int j = i % n;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += partial[(j * kStats + s) * kWarps + w];
        stats[static_cast<size_t>(s) * K + base + j] = sum;
      }
    }
  }
  if constexpr (kWithStats) {
    // Entries past the block-wide exit were never visited.
    for (int idx = base + tid; idx < end; idx += kPixels) {
#pragma unroll
      for (int s = 0; s < kStats; ++s) {
        stats[static_cast<size_t>(s) * K + idx] = 0.0f;
      }
    }
  }
  const int pix = tile * kPixels + box.pixel;
  color4[pix] = make_float4(cr, cg, cb, cd);
  final_t[pix] = T;
  latch[pix] = lat;
}

template <bool kWithStats>
int launch(const float* e, int K, const int* range_start, const int* range_end,
           int* tile_order, int num_tiles, int tiles_x, float* color4,
           float* final_t, int* latch, float* stats, void* stream) {
  if (num_tiles <= 0) return 0;
  const int err = tile_common::launch_tile_order(
      range_start, range_end, num_tiles, tile_order, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const int dynamic_smem = kWithStats ? kStatsBytes : 0;
  if (kWithStats) {
    // The statistics' partial sums and the staging together pass the 48 KB
    // a block gets without asking.
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_kernel<kWithStats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_fwd_kernel<kWithStats>
      <<<num_tiles, kPixels, dynamic_smem, static_cast<cudaStream_t>(stream)>>>(
          e, K, range_start, range_end, tile_order, tiles_x,
          reinterpret_cast<float4*>(color4), final_t, latch, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the compositor on `stream` for `num_tiles` tiles and returns
// cudaGetLastError() (0 on success). e: float32 [10, K]; range_start,
// range_end: int32 [num_tiles]; tile_order: int32 [num_tiles], scratch that
// the launch fills with the tiles, longest first (block i composites tile
// tile_order[i]); color4: float32
// [num_tiles, 256, 4]; final_t: float32 [num_tiles, 256]; latch: int32
// [num_tiles, 256].
extern "C" int composite_fwd(const float* e, int K, const int* range_start,
                             const int* range_end, int* tile_order,
                             int num_tiles, int tiles_x, float* color4,
                             float* final_t, int* latch, void* stream) {
  return launch<false>(e, K, range_start, range_end, tile_order, num_tiles,
                       tiles_x, color4, final_t, latch, nullptr, stream);
}

// As composite_fwd, and writes stats: float32 [4, K], per sorted entry the
// contributing-pixel count, count x opacity, the sum of w and the sum of
// T_in, every entry written.
extern "C" int composite_fwd_stats(const float* e, int K,
                                   const int* range_start,
                                   const int* range_end,
                                   int* tile_order, int num_tiles,
                                   int tiles_x, float* color4, float* final_t,
                                   int* latch, float* stats, void* stream) {
  return launch<true>(e, K, range_start, range_end, tile_order, num_tiles,
                      tiles_x, color4, final_t, latch, stats, stream);
}
