// Forward tile compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fwd_kernel
// (reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300-423, launched by
// tile_composite_fwd, :426-495, with_stats=False). The function is the
// forward pass of the CUDA 3DGS rasterizer that the Pallas kernel was itself
// modelled on; see reduced_3dgs_torch/ops/rasterize/composite.py for the
// contract and for composite_fwd_plain, the plain PyTorch version this kernel
// is held against.
//
// Design (the simple correct one): one thread block per 16x16 tile, one
// thread per pixel. The block walks its tile's sorted entries
// [range_start[t], range_end[t]) in batches of 256, staged field by field
// into shared memory (10 x 256 floats = 10 KB); every thread then runs the
// sequential front-to-back test over the batch with T, its colour and depth
// sums and its latch in registers. Once every pixel of the block has latched,
// __syncthreads_count ends the walk. Threads of pixels outside the image stay
// in the loop, so every thread reaches every barrier.
//
// Bound on the card: each (pixel, entry) pair scanned costs ~13 float32
// operations (offsets, quadratic form, exp, gates) plus ~10 more when it
// contributes. At the 200k-Gaussian 544x976 bench scene (K ~ 0.6M entries,
// <= 1.6e8 pairs) that is tens of microseconds at the 67 TFLOP/s float32
// peak, while the bytes (entries 40 B each, outputs 24 B per pixel, ~37 MB)
// take ~11 us at 3.35 TB/s: the kernel is bound by operations and by the
// latency of the per-pixel sequential loop, not by memory. Double-buffered
// staging, fusing the gather e = fields10[:, s_gidx] into the staging load,
// and a warp per pixel row are for a later change.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kFields = 10;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ e, int K,
                     const int* __restrict__ range_start,
                     const int* __restrict__ range_end, int tiles_x,
                     float4* __restrict__ color4, float* __restrict__ final_t,
                     int* __restrict__ latch) {
  __shared__ float fields[kFields][kPixels];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = range_start[tile];
  const int end = range_end[tile];

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int lat = end;  // no latch
  int done = 0;
  for (int base = start; base < end; base += kPixels) {
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
    for (int j = 0; j < n && !done; ++j) {
      const float dx = fields[0][j] - px;
      const float dy = fields[1][j] - py;
      const float power =
          -0.5f * (fields[2][j] * dx * dx + fields[4][j] * dy * dy) -
          fields[3][j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, fields[5][j] * expf(power));
      if (alpha < kAlphaEps) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {  // the latching entry is excluded too
        lat = base + j;
        done = 1;
        break;
      }
      const float w = alpha * T;
      cr += w * fields[6][j];
      cg += w * fields[7][j];
      cb += w * fields[8][j];
      cd += w * fields[9][j];
      T = test_t;
    }
  }
  const int pix = tile * kPixels + tid;
  color4[pix] = make_float4(cr, cg, cb, cd);
  final_t[pix] = T;
  latch[pix] = lat;
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
  if (num_tiles <= 0) return 0;
  composite_fwd_kernel<<<num_tiles, kPixels, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      e, K, range_start, range_end, tiles_x,
      reinterpret_cast<float4*>(color4), final_t, latch);
  return static_cast<int>(cudaGetLastError());
}
