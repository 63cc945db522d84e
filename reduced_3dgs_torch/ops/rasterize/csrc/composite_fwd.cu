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
// tiles now set the span: each takes ~130 us of the kernel's ~140 us. The
// statistics form's first design visited every entry with every warp
// (5.0e6 visits) and summed four values per visit with 5-step butterflies
// into 32 KB of per-warp partials: 0.48 ms of device time, of which the
// shuffles took ~0.045 ms. On the forward form's walk with the slots below
// it takes ~0.22 ms (same tool and card): no cull +0.22 ms, warps of two
// pixel rows +0.04 ms; shared atomics in place of the slots, or the
// reduce-scatter's shuffles removed, within the noise.
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
// time (walk_batch, which both forms run): each lane tests one entry's
// ellipse against the box (tile_common::may_touch, conservative), and the
// warp's pixels blend, front to back, the entries a ballot keeps, with T,
// the colour and depth sums and the latch in registers; a pixel stops at its
// latch, a warp when all of its pixels have. Once every pixel of the block
// has latched, __syncthreads_count ends the walk. Threads of pixels outside
// the image stay in the loop, so every thread reaches every barrier; they
// also count in the statistics, as in the JAX package (its pixel grid has
// no in-image mask). The gate's quadratic form is rounded op by op in the
// plain version's order, so that the statistics' counts equal the plain
// version's.
//
// Statistics (kWithStats): for each sorted entry, over the tile's pixels
// where it contributes (gated and before the pixel's latch), the count, the
// count times the entry's opacity, the sum of the blend weights
// w = alpha T_in and the sum of the incoming transmittance. The walk is the
// forward form's, cull and stop included, so both forms blend the same
// entries in the same order through the same inlined code, and their
// colour, T and latch are the same bits. At each entry a warp visits, the
// count is __popc of a ballot of the contributing lanes, and the two float
// sums take one reduce-scatter (5 shuffles, skipped when no lane
// contributes). Each warp writes its count and sums into its own slot of
// the entry (an 8-bit count and two floats per warp and entry of the batch,
// 18 KB beside the 24 KB of staging, so five blocks fit on an SM, no
// dynamic shared memory): the lanes that hold them for a visited
// entry, the lane that tested it for an entry the ballot dropped, and zeros
// from all lanes for the entries after the warp's stop. After a barrier,
// one thread per entry adds the eight slots in warp order and writes the
// entry's four statistics, the second as float(count) * opacity, the plain
// version's own rounding. So every statistic is the same bits from run to
// run. Each sorted entry belongs to one tile, so one block writes it once:
// no global atomics. Entries past the block-wide exit are written as zeros.
//
// Left for a later change: fusing the gather e = fields10[:, s_gidx] into
// the staging and the statistics' per-Gaussian sum (an index_add_ in the
// callers) into the combine.
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
constexpr unsigned kFullMask = 0xffffffffu;
using tile_common::kAlphaEps;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

enum Blend { kSkip, kContrib, kLatch };

// A pixel's state: its transmittance, colour and depth sums, the sorted
// position of its latching entry (the tile's range end until it latches)
// and whether it has latched.
struct Pixel {
  float T, cr, cg, cb, cd;
  int lat, done;
};

// kWithStats: per warp and entry of the batch, the warp's count of
// contributing pixels and its sums of w and of T_in.
template <bool kWithStats>
struct StatSlots {
  unsigned char count[kWarps][kPixels];
  float w[kWarps][kPixels];
  float t[kWarps][kPixels];

  __device__ __forceinline__ void clear(int warp, int j) {
    count[warp][j] = 0;
    w[warp][j] = 0.0f;
    t[warp][j] = 0.0f;
  }
};

template <>
struct StatSlots<false> {};

// Reduce-scatter of the pair (a, b) over the warp's lanes (the two-value
// case of composite_bwd.cu's reduce_scatter): the first shuffle leaves b's
// partial sums on lanes 16-31 and a's on the others, four more add each
// half whole. Returns the warp sum of a on lanes 0-15 and of b on 16-31.
__device__ __forceinline__ float reduce_scatter2(float a, float b, int lane) {
  const bool upper = lane & 16;
  float v = (upper ? b : a) + __shfl_xor_sync(kFullMask, upper ? a : b, 16);
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFullMask, v, offset);
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

// One staged batch of n entries (sorted positions base ...) through the
// warp whose box is `box`, the walk both forms run: 32 entries at a time,
// lane k tests entry j0 + k against the box, and the warp's pixels that
// have not latched blend, front to back, the entries some pixel there can
// blend; the warp stops once all of its pixels have latched. kWithStats:
// also writes the warp's slot of every entry of the batch, once.
template <bool kWithStats>
__device__ __forceinline__ void walk_batch(const float4* batch, int n, int base,
                                           const tile_common::WarpBox& box, int lane,
                                           int warp, Pixel& p, StatSlots<kWithStats>& slots) {
  const float px = box.px;
  const float py = box.py;
  int j0 = 0;
  for (; j0 < n && !__all_sync(kFullMask, p.done); j0 += 32) {
    const int jl = j0 + lane;
    const float4* ql = batch + 3 * jl;
    const bool hit =
        jl < n && tile_common::may_touch(ql[0], ql[1], box.x0, box.x1, box.y0, box.y1);
    if constexpr (kWithStats) {
      if (jl < n && !hit) slots.clear(warp, jl);  // dropped by the cull
    }
    for (unsigned bits = __ballot_sync(kFullMask, hit); bits; bits &= bits - 1) {
      const int j = j0 + __ffs(bits) - 1;
      const float T_in = p.T;
      float w = 0.0f;
      Blend b = kSkip;
      if (!p.done) {
        b = blend(batch + 3 * j, px, py, p.T, p.cr, p.cg, p.cb, p.cd, w);
        if (b == kLatch) {
          p.lat = base + j;  // the latching entry is excluded too
          p.done = 1;
        }
      }
      if constexpr (kWithStats) {
        const bool contrib = b == kContrib;
        const unsigned who = __ballot_sync(kFullMask, contrib);
        float sum = 0.0f;
        // Warp-uniform branch: every lane of the warp takes the same side.
        if (who) sum = reduce_scatter2(contrib ? w : 0.0f, contrib ? T_in : 0.0f, lane);
        if (lane == 0) {
          slots.count[warp][j] = __popc(who);
          slots.w[warp][j] = sum;
        } else if (lane == 16) {
          slots.t[warp][j] = sum;
        }
      }
    }
  }
  if constexpr (kWithStats) {
    for (int j = j0 + lane; j < n; j += 32) slots.clear(warp, j);  // after the warp's stop
  }
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
  __shared__ StatSlots<kWithStats> slots;
  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const tile_common::WarpBox box = tile_common::warp_box<kWarpWidth>(tile, tiles_x, tid);
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

  Pixel p{1.0f, 0.0f, 0.0f, 0.0f, 0.0f, end, 0};
  int base = start;
  int buf = 0;
  if (start < end) stage_batch(start, 0);
  for (; base < end; base += kPixels, buf ^= 1) {
    // The batch at `base` is staged, nobody reads the other buffer or the
    // slots any more, and the block-wide exit.
    __pipeline_wait_prior(0);
    if (__syncthreads_count(p.done) == kPixels) break;
    if (base + kPixels < end) stage_batch(base + kPixels, buf ^ 1);
    const int n = min(kPixels, end - base);
    const float4* batch = reinterpret_cast<const float4*>(stage[buf]);
    walk_batch<kWithStats>(batch, n, base, box, lane, warp, p, slots);
    if constexpr (kWithStats) {
      // Every warp's slot of every entry of the batch is written: thread
      // tid adds entry tid's eight, in warp order.
      __syncthreads();
      if (tid < n) {
        int count = 0;
        float ws = 0.0f;
        float ts = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          count += slots.count[w][tid];
          ws += slots.w[w][tid];
          ts += slots.t[w][tid];
        }
        const float cnt = static_cast<float>(count);
        const size_t idx = base + tid;
        stats[idx] = cnt;
        stats[static_cast<size_t>(K) + idx] = cnt * batch[3 * tid + 1].y;  // x opacity
        stats[2 * static_cast<size_t>(K) + idx] = ws;
        stats[3 * static_cast<size_t>(K) + idx] = ts;
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
  color4[pix] = make_float4(p.cr, p.cg, p.cb, p.cd);
  final_t[pix] = p.T;
  latch[pix] = p.lat;
}

template <bool kWithStats>
int launch(const float* e, int K, const int* range_start, const int* range_end,
           int* tile_order, int num_tiles, int tiles_x, float* color4,
           float* final_t, int* latch, float* stats, void* stream) {
  if (num_tiles <= 0) return 0;
  const int err = tile_common::launch_tile_order(
      range_start, range_end, num_tiles, tile_order, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  composite_fwd_kernel<kWithStats>
      <<<num_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
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
