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
// Design (the simple correct one): one thread block per 16x16 tile, one
// thread per pixel. The block walks its tile's sorted entries
// [range_start[t], range_end[t]) in batches of 256, staged field by field
// into shared memory (10 x 256 floats = 10 KB); every thread then runs the
// sequential front-to-back test over the batch with T, its colour and depth
// sums and its latch in registers. Once every pixel of the block has latched,
// __syncthreads_count ends the walk. Threads of pixels outside the image stay
// in the loop, so every thread reaches every barrier; they also count in the
// statistics, as in the JAX package (its pixel grid has no in-image mask).
//
// Statistics (kWithStats): for each sorted entry, over the tile's pixels
// where it contributes (gated and before the pixel's latch), the count, the
// count times the entry's opacity (summed as op per pixel), the sum of the
// blend weights w = alpha T_in and the sum of the incoming transmittance. Each
// thread then visits every entry of the batch, latched or not, so that the
// per-entry sums are warp-uniform: a __shfl_xor_sync butterfly per statistic
// (skipped when __any_sync finds no contributing lane), the eight warp sums
// combined from shared memory after the batch (4 x 8 floats per entry, 32 KB
// per batch). Each sorted entry belongs to one tile, so one block writes its
// statistics once: no atomics. Entries the walk never reaches (past the
// block-wide exit) are written as zeros. Both forms blend through the same
// inlined function, so their colour, T and latch are the same bits.
//
// Bound on the card: each (pixel, entry) pair scanned costs ~13 float32
// operations (offsets, quadratic form, exp, gates) plus ~10 more when it
// contributes. At the 200k-Gaussian 544x976 bench scene (K ~ 0.6M entries,
// <= 1.6e8 pairs) that is tens of microseconds at the 67 TFLOP/s float32
// peak, while the bytes (entries 40 B each, outputs 24 B per pixel, ~37 MB;
// 16 B per entry more for the statistics) take ~11 us at 3.35 TB/s: the
// kernel is bound by operations and by the latency of the per-pixel
// sequential loop, not by memory. The statistics form also walks every entry
// of a batch after a pixel's latch (without blending it) and runs four 5-step
// butterflies per entry where a lane contributes. Double-buffered staging,
// fusing the gather e = fields10[:, s_gidx] into the staging load, and a warp
// per pixel row are for a later change.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kFields = 10;
constexpr int kStats = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
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

// Blends staged entry j into the pixel (px, py). Returns kSkip when the entry
// is gated out, kLatch when it would take T below 1e-4 (it is excluded and
// the pixel is done), and kContrib otherwise, with the colour, depth and T
// updated and w = alpha T_in.
__device__ __forceinline__ Blend blend(float (*fields)[kPixels], int j,
                                       float px, float py, float& T,
                                       float& cr, float& cg, float& cb,
                                       float& cd, float& w) {
  const float dx = fields[0][j] - px;
  const float dy = fields[1][j] - py;
  // -0.5 (A dx^2 + C dy^2) - B dx dy with every product and sum rounded on
  // its own (no FMA contraction), in the plain version's order: the gates
  // then decide exactly as the plain version's do, and the statistics'
  // counts are compared exactly.
  const float power = __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(fields[2][j], dx), dx),
                                 __fmul_rn(__fmul_rn(fields[4][j], dy), dy))),
      __fmul_rn(__fmul_rn(fields[3][j], dx), dy));
  if (power > 0.0f) return kSkip;
  const float alpha = fminf(kAlphaMax, fields[5][j] * expf(power));
  if (alpha < kAlphaEps) return kSkip;
  const float test_t = T * (1.0f - alpha);
  if (test_t < kTEps) return kLatch;
  w = alpha * T;
  cr += w * fields[6][j];
  cg += w * fields[7][j];
  cb += w * fields[8][j];
  cd += w * fields[9][j];
  T = test_t;
  return kContrib;
}

template <bool kWithStats>
__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ e, int K,
                     const int* __restrict__ range_start,
                     const int* __restrict__ range_end, int tiles_x,
                     float4* __restrict__ color4, float* __restrict__ final_t,
                     int* __restrict__ latch, float* __restrict__ stats) {
  __shared__ float fields[kFields][kPixels];
  __shared__ float partial[kWithStats ? kPixels : 1][kStats][kWarps];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = range_start[tile];
  const int end = range_end[tile];

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int lat = end;  // no latch
  int done = 0;
  int base = start;
  for (; base < end; base += kPixels) {
    // Barrier before overwriting the previous batch, and the block-wide exit.
    if (__syncthreads_count(done) == kPixels) break;
    const int idx = base + tid;
    if (idx < end) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        fields[f][tid] = e[static_cast<size_t>(f) * K + idx];
      }
    }
    __syncthreads();
    const int n = min(kPixels, end - base);
    if constexpr (!kWithStats) {
      for (int j = 0; j < n && !done; ++j) {
        float w;
        if (blend(fields, j, px, py, T, cr, cg, cb, cd, w) == kLatch) {
          lat = base + j;  // the latching entry is excluded too
          done = 1;
        }
      }
    } else {
      for (int j = 0; j < n; ++j) {
        float v[kStats] = {0.0f, 0.0f, 0.0f, 0.0f};
        bool contrib = false;
        if (!done) {
          const float T_in = T;
          float w = 0.0f;
          const Blend b = blend(fields, j, px, py, T, cr, cg, cb, cd, w);
          if (b == kLatch) {
            lat = base + j;
            done = 1;
          }
          contrib = b == kContrib;
          if (contrib) {
            v[0] = 1.0f;
            v[1] = fields[5][j];
            v[2] = w;
            v[3] = T_in;
          }
        }
        // Warp-uniform branch: every lane of the warp takes the same side.
        if (__any_sync(kFullMask, contrib)) {
#pragma unroll
          for (int s = 0; s < kStats; ++s) {
            const float sum = warp_sum(v[s]);
            if (lane == 0) partial[j][s][warp] = sum;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int s = 0; s < kStats; ++s) partial[j][s][warp] = 0.0f;
        }
      }
      __syncthreads();
      for (int i = tid; i < n * kStats; i += kPixels) {
        const int s = i / n;
        const int j = i % n;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += partial[j][s][w];
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
  const int pix = tile * kPixels + tid;
  color4[pix] = make_float4(cr, cg, cb, cd);
  final_t[pix] = T;
  latch[pix] = lat;
}

template <bool kWithStats>
int launch(const float* e, int K, const int* range_start, const int* range_end,
           int num_tiles, int tiles_x, float* color4, float* final_t,
           int* latch, float* stats, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_fwd_kernel<kWithStats>
      <<<num_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
          e, K, range_start, range_end, tiles_x,
          reinterpret_cast<float4*>(color4), final_t, latch, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the compositor on `stream` for `num_tiles` tiles and returns
// cudaGetLastError() (0 on success). e: float32 [10, K]; range_start,
// range_end: int32 [num_tiles]; color4: float32 [num_tiles, 256, 4];
// final_t: float32 [num_tiles, 256]; latch: int32 [num_tiles, 256].
extern "C" int composite_fwd(const float* e, int K, const int* range_start,
                             const int* range_end, int num_tiles, int tiles_x,
                             float* color4, float* final_t, int* latch,
                             void* stream) {
  return launch<false>(e, K, range_start, range_end, num_tiles, tiles_x,
                       color4, final_t, latch, nullptr, stream);
}

// As composite_fwd, and writes stats: float32 [4, K], per sorted entry the
// contributing-pixel count, count x opacity, the sum of w and the sum of
// T_in, every entry written.
extern "C" int composite_fwd_stats(const float* e, int K,
                                   const int* range_start,
                                   const int* range_end, int num_tiles,
                                   int tiles_x, float* color4, float* final_t,
                                   int* latch, float* stats, void* stream) {
  return launch<true>(e, K, range_start, range_end, num_tiles, tiles_x,
                      color4, final_t, latch, stats, stream);
}
