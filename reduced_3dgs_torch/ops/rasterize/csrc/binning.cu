// Binning and sort for NVIDIA Hopper (sm_90a): the (tile, Gaussian) entries
// of a render, ordered by tile, then view depth, then Gaussian index, with
// each tile's range in that order.
//
// Replaces no Pallas kernel: the JAX package bins in XLA
// (reduced_3dgs_tpu/ops/rasterize/tiled.py:174-370). The port's plain
// version, tiled.bin_and_sort_plain, emits the entries in Gaussian order
// and sorts int64 keys (tile << 32 | depth bits) over all 64 bits with
// int64 indices, around some 35 elementwise, gather and scan passes over
// the [K] buffer. See reduced_3dgs_torch/ops/rasterize/binning_kernel.py
// for the contract; the outputs are the plain version's, bit for bit.
//
// What bounds it on this card: bytes. It must read a Gaussian's rect, tile
// count and depth (24 B) and write each entry's tile and Gaussian id
// (int64) and, for a static buffer, its valid flag (17 B). At 1.25M
// Gaussians and K = 10,380,288 that is ~206 MB, 0.061 ms at 3.35 TB/s.
//
// Design. No Gaussian has two entries in one tile, so within a tile the
// order is (depth bits, Gaussian index), and it comes from sorting the N
// Gaussians once instead of the K entries on 64 bits:
//   1. count_kernel: each Gaussian's entry count from its rect clipped to
//      the band; an inclusive scan in index order gives the offsets and
//      the total (num_rendered). A static K keeps the entries that fit in
//      index order, kept = clamp(min(count, K - offset), 0): the plain
//      version's rule, so an overflow drops the same entries.
//   2. a stable radix sort of the Gaussians by their 32 depth bits, the
//      index as value (ties keep index order; Gaussians without entries
//      take 0xFFFFFFFF and emit nothing);
//   3. kept_kernel gathers kept in that order, an inclusive scan gives the
//      write ends, and emit_kernel writes each entry's tile id (uint32) and
//      Gaussian id (int32) there, ordinals row-major in the rect. A block
//      takes 256 consecutive Gaussians and its threads take consecutive
//      entries of the block's run, each finding its Gaussian by binary
//      search over the ends in shared memory: the writes coalesce and a
//      rect of hundreds of tiles costs its block a few more rounds. Extra
//      blocks fill a static buffer's tail, [kept total, K), with the
//      sentinel tile T;
//   4. a stable radix sort of the K (tile, id) pairs on the bits T needs
//      (12 for 2,170 tiles: 2 onesweep passes of 8-byte pairs). The tail's
//      key T is the largest, so it keeps its positions;
//   5. finish_kernel writes s_tile and s_gidx as int64, the valid flags,
//      the tail's scratch ids and, from each position's tile and its
//      predecessor's, the tile ranges: tiles in (s_tile[i-1], s_tile[i]]
//      start at i and tiles in [s_tile[i-1], s_tile[i]) end at i, which is
//      torch.searchsorted's left and right answer, empty tiles included.
// The two sorts and the two scans are CUB's (DeviceRadixSort::SortPairs,
// the onesweep sort torch.sort launches, and DeviceScan::InclusiveSum) on
// PyTorch's stream, with scratch the wrapper allocates; nothing here
// synchronises, so a static buffer's binning is captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kNoDepth = 0xFFFFFFFFu;
// Blocks that fill a static buffer's tail (grid-stride over [total, K)).
constexpr int kTailBlocks = 1024;

__device__ __forceinline__ int clamp_rows(int y, int tiles_y) {
  return min(max(y, 0), tiles_y);
}

// Step 1: counts [n] int64, offsets[0] = 0, depth keys and index values.
__global__ void __launch_bounds__(kBlock)
count_kernel(int n, const int* __restrict__ rect_min, const int* __restrict__ rect_max,
             const int* __restrict__ tiles_touched, const unsigned* __restrict__ depth_bits,
             int tiles_y, int tile_row_offset, long long* __restrict__ counts,
             long long* __restrict__ offsets, unsigned* __restrict__ keys,
             int* __restrict__ ids) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i == 0) offsets[0] = 0;
  if (i >= n) return;
  const long long w = rect_max[2 * i] - rect_min[2 * i];
  const int y0 = clamp_rows(rect_min[2 * i + 1] - tile_row_offset, tiles_y);
  const int y1 = clamp_rows(rect_max[2 * i + 1] - tile_row_offset, tiles_y);
  const long long h = max(y1 - y0, 0);
  const long long c = tiles_touched[i] > 0 ? w * h : 0;
  counts[i] = c;
  keys[i] = c > 0 ? depth_bits[i] : kNoDepth;
  ids[i] = i;
}

// Step 3a: the entries each Gaussian keeps, in depth order.
__global__ void __launch_bounds__(kBlock)
kept_kernel(int n, long long K, const int* __restrict__ order,
            const long long* __restrict__ counts, const long long* __restrict__ offsets,
            int* __restrict__ kept) {
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= n) return;
  const int g = order[j];
  const long long k = min(counts[g], K - offsets[g]);
  kept[j] = static_cast<int>(max(k, 0LL));
}

// Step 3b: the entries, written at their depth-order positions; blocks
// from gblocks on (launched for a static buffer) fill the tail
// [ends[n-1], K).
__global__ void __launch_bounds__(kBlock)
emit_kernel(int n, int K, const int* __restrict__ order, const int* __restrict__ ends,
            const int* __restrict__ rect_min, const int* __restrict__ rect_max, int tiles_x,
            int tiles_y, int tile_row_offset, unsigned num_tiles, int tail_scratch,
            int gblocks, unsigned* __restrict__ tiles, int* __restrict__ ids) {
  if (static_cast<int>(blockIdx.x) >= gblocks) {
    const int total = n > 0 ? ends[n - 1] : 0;
    const int stride = (gridDim.x - gblocks) * kBlock;
    for (int p = total + (blockIdx.x - gblocks) * kBlock + threadIdx.x; p < K; p += stride) {
      tiles[p] = num_tiles;
      ids[p] = n + p % tail_scratch;
    }
    return;
  }
  __shared__ int s_end[kBlock], s_gid[kBlock], s_x0[kBlock], s_y0[kBlock], s_w[kBlock];
  const int j0 = blockIdx.x * kBlock;
  const int m = min(kBlock, n - j0);
  const int t = threadIdx.x;
  if (t < m) {
    const int g = order[j0 + t];
    const int x0 = rect_min[2 * g];
    s_end[t] = ends[j0 + t];
    s_gid[t] = g;
    s_x0[t] = x0;
    s_y0[t] = clamp_rows(rect_min[2 * g + 1] - tile_row_offset, tiles_y);
    s_w[t] = max(rect_max[2 * g] - x0, 1);
  }
  __syncthreads();
  const int start = j0 > 0 ? ends[j0 - 1] : 0;
  const int stop = s_end[m - 1];
  for (int p = start + t; p < stop; p += kBlock) {
    int lo = 0, hi = m - 1;  // the first Gaussian of the block whose run ends past p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_end[mid] > p) hi = mid; else lo = mid + 1;
    }
    const int ordinal = p - (lo > 0 ? s_end[lo - 1] : start);
    const int w = s_w[lo];
    tiles[p] = static_cast<unsigned>((s_y0[lo] + ordinal / w) * tiles_x + s_x0[lo] +
                                     ordinal % w);
    ids[p] = s_gid[lo];
  }
}

// Step 5: over positions 0..K (K + 1 threads).
__global__ void __launch_bounds__(kBlock)
finish_kernel(int K, int n, int num_tiles, int tail_scratch, const unsigned* __restrict__ tiles,
              const int* __restrict__ ids, const long long* __restrict__ total,
              long long* __restrict__ s_tile, long long* __restrict__ s_gidx,
              bool* __restrict__ valid, bool* __restrict__ overflow,
              int* __restrict__ range_start, int* __restrict__ range_end) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i > K) return;
  if (i == 0 && overflow != nullptr) *overflow = *total > K;
  const int cur = i < K ? static_cast<int>(tiles[i]) : num_tiles;
  const int prev = i > 0 ? static_cast<int>(tiles[i - 1]) : -1;
  if (i < K) {
    const bool in_tile = cur < num_tiles;
    s_tile[i] = cur;
    s_gidx[i] = in_tile ? static_cast<long long>(ids[i]) : n + i % tail_scratch;
    if (valid != nullptr) valid[i] = in_tile;
  }
  for (int t = max(prev + 1, 0); t <= min(cur, num_tiles - 1); ++t) range_start[t] = i;
  for (int t = max(prev, 0); t < min(cur, num_tiles); ++t) range_end[t] = i;
}

int blocks(long long items) { return static_cast<int>((items + kBlock - 1) / kBlock); }

}  // namespace

// Scratch bytes of the CUB calls: *count_bytes for binning_count's scan over
// n int64 counts, *sort_bytes for binning_sort's depth sort and scan over n
// and its tile sort over k entries on `bits` bits. Host only.
extern "C" int binning_scratch_bytes(int n, int k, int bits, long long* count_bytes,
                                     long long* sort_bytes) {
  size_t scan64 = 0, depth = 0, scan32 = 0, tile = 0;
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> values(nullptr, nullptr);
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    err = cub::DeviceScan::InclusiveSum(nullptr, scan64, static_cast<const long long*>(nullptr),
                                        static_cast<long long*>(nullptr), n);
    if (err == cudaSuccess)
      err = cub::DeviceRadixSort::SortPairs(nullptr, depth, keys, values, n, 0, 32);
    if (err == cudaSuccess)
      err = cub::DeviceScan::InclusiveSum(nullptr, scan32, static_cast<const int*>(nullptr),
                                          static_cast<int*>(nullptr), n);
  }
  if (err == cudaSuccess && k > 0)
    err = cub::DeviceRadixSort::SortPairs(nullptr, tile, keys, values, k, 0, bits);
  *count_bytes = static_cast<long long>(scan64);
  *sort_bytes = static_cast<long long>(std::max(std::max(depth, scan32), tile));
  return static_cast<int>(err);
}

// Step 1 on `stream`: counts [n] int64, offsets [n + 1] int64 (offsets[i]
// the entries of the Gaussians before i, offsets[n] the total), and the
// depth sort's input: keys [n] (depth bits, 0xFFFFFFFF without entries)
// and ids [n] (0..n-1). rect_min, rect_max [n, 2] int32; tiles_touched [n]
// int32; depth_bits [n], the float32 depths' bits. Returns cudaError_t.
extern "C" int binning_count(int n, const int* rect_min, const int* rect_max,
                             const int* tiles_touched, const unsigned* depth_bits, int tiles_y,
                             int tile_row_offset, long long* counts, long long* offsets,
                             unsigned* keys, int* ids, void* scratch, long long scratch_bytes,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<std::max(blocks(n), 1), kBlock, 0, s>>>(
      n, rect_min, rect_max, tiles_touched, depth_bits, tiles_y, tile_row_offset, counts,
      offsets, keys, ids);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  size_t bytes = static_cast<size_t>(scratch_bytes);
  err = cub::DeviceScan::InclusiveSum(scratch, bytes, counts, offsets + 1, n, s);
  return static_cast<int>(err);
}

// Steps 2-5 on `stream`, after binning_count: the K sorted entries and the
// tile ranges. keys/keys_alt, ids/ids_alt: the depth sort's double buffers
// [n] (keys and ids as binning_count left them); kept, ends [n] int32;
// tiles_a/tiles_b, gid_a/gid_b: the tile sort's double buffers [K]. Writes
// s_tile, s_gidx [K] int64, range_start, range_end [num_tiles] int32 and,
// when `valid` is not null (a static buffer), valid [K] bool, *overflow
// (offsets[n] > K), the tail's sentinel tile and scratch ids
// n + position % tail_scratch. bits: the tile sort's key bits, enough for
// num_tiles. Returns cudaError_t.
extern "C" int binning_sort(int n, int K, int num_tiles, int tiles_x, int tiles_y,
                            int tile_row_offset, int bits, int tail_scratch, const int* rect_min,
                            const int* rect_max, const long long* counts,
                            const long long* offsets, unsigned* keys, unsigned* keys_alt,
                            int* ids, int* ids_alt, int* kept, int* ends, unsigned* tiles_a,
                            unsigned* tiles_b, int* gid_a, int* gid_b, void* scratch,
                            long long scratch_bytes, long long* s_tile, long long* s_gidx,
                            bool* valid, bool* overflow, int* range_start, int* range_end,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool is_static = valid != nullptr;
  cudaError_t err = cudaSuccess;
  int* order = ids;
  if (n > 0) {
    cub::DoubleBuffer<unsigned> dkeys(keys, keys_alt);
    cub::DoubleBuffer<int> dids(ids, ids_alt);
    size_t bytes = static_cast<size_t>(scratch_bytes);
    err = cub::DeviceRadixSort::SortPairs(scratch, bytes, dkeys, dids, n, 0, 32, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    order = dids.Current();
    kept_kernel<<<blocks(n), kBlock, 0, s>>>(n, K, order, counts, offsets, kept);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bytes = static_cast<size_t>(scratch_bytes);
    err = cub::DeviceScan::InclusiveSum(scratch, bytes, kept, ends, n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gblocks = blocks(n);
  const int tail_blocks = is_static && K > 0 ? std::min(blocks(K), kTailBlocks) : 0;
  if (gblocks + tail_blocks > 0) {
    emit_kernel<<<gblocks + tail_blocks, kBlock, 0, s>>>(
        n, K, order, ends, rect_min, rect_max, tiles_x, tiles_y, tile_row_offset,
        static_cast<unsigned>(num_tiles), tail_scratch, gblocks, tiles_a, gid_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned* sorted_tiles = tiles_a;
  const int* sorted_ids = gid_a;
  if (K > 0) {
    cub::DoubleBuffer<unsigned> tkeys(tiles_a, tiles_b);
    cub::DoubleBuffer<int> tids(gid_a, gid_b);
    size_t bytes = static_cast<size_t>(scratch_bytes);
    err = cub::DeviceRadixSort::SortPairs(scratch, bytes, tkeys, tids, K, 0, bits, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    sorted_tiles = tkeys.Current();
    sorted_ids = tids.Current();
  }
  finish_kernel<<<blocks(static_cast<long long>(K) + 1), kBlock, 0, s>>>(
      K, n, num_tiles, tail_scratch, sorted_tiles, sorted_ids, offsets + n, s_tile, s_gidx,
      valid, overflow, range_start, range_end);
  return static_cast<int>(cudaGetLastError());
}
