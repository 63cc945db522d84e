// Adam over every parameter of one optimizer state in a single pass, for
// NVIDIA Hopper (sm_90a) (adam_kernel).
//
// Replaces no Pallas kernel: the JAX package's update
// (reduced_3dgs_tpu/trainer/optimizer.py:19-49) is plain jnp, which XLA fuses
// into one pass over each parameter. In eager PyTorch the same update,
// reduced_3dgs_torch/trainer/optimizer.py's adam_plain (the version this
// kernel is held against), is ~11 full-size elementwise kernels a parameter,
// each reading and writing whole tensors: ~104 B a float of the model.
//
// What bounds it on this card: bytes. Each float of a parameter reads p, g, m
// and v and writes p, m and v: 28 B (16 B when the gradient is missing), for
// ~10 float operations. At 1,250,000 Gaussians (59 floats each, 73.75M
// floats) that is 2.07 GB, 0.62 ms at 3.35 TB/s.
//
// Design. One launch for all the tensors of a state (up to kMaxTensors):
// their addresses, sizes and learning rates travel in the kernel's arguments
// as a struct by value, so a captured CUDA graph keeps them. The tensors lie
// end to end in one index space of 4-float chunks, a thread a chunk: it
// finds its tensor among the chunk counts, and takes a whole chunk as 16-byte
// loads and stores when the tensor's arrays all start on 16 bytes, else float
// by float (a size is arbitrary after an event). A missing gradient (a NULL
// address) is a zero gradient. The step count and a learning rate given by
// address (the xyz schedule's) are read from device memory at each run, so a
// replayed graph reads the count it has reached.
//
// At 1,250,000 Gaussians (NVIDIA H100 80GB HBM3, 700 W; device time under
// torch.profiler with the L2 flushed) the step takes 0.684 ms, 90% of the
// bound, against 2.56 ms for the plain version's kernels. A grid-stride loop
// over 8 blocks an SM took 0.751 ms, 64 blocks an SM 0.728; streaming loads
// and stores (__ldcs, __stcs) 0.789; capping the registers at 40 for six
// blocks an SM spilled and took 1.157.
//
// Arithmetic: float32, in the plain version's order and roundings, with IEEE
// division and square root (eps is 1e-15: an approximate reciprocal square
// root would move the result where v is near 0):
//   m = b1 m + (1 - b1) g        (m b1 rounded, then one fused multiply-add)
//   v = b2 v + (1 - b2) g g      (v b2 rounded, then (1 - b2) g fused with g)
//   p = p - lr (m / bc1) / (sqrt(v / bc2) + eps),  bc = 1 - b^t, t the count
// where 1 - b1 and 1 - b2 come from the host as the plain version forms them
// (in double, then rounded to float32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The build defines ADAM_MAX_TENSORS (_build.py's ADAM_MAX_TENSORS).
constexpr int kMaxTensors = ADAM_MAX_TENSORS;
constexpr int kThreads = 256;

struct AdamTensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];      // NULL: a zero gradient
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* lr_at[kMaxTensors];  // NULL: the rate is lr[i]
  float lr[kMaxTensors];
  long long size[kMaxTensors];      // floats
  long long end[kMaxTensors];       // chunks of the tensors up to this one's end
  unsigned aligned;                 // bit i: tensor i's arrays start on 16 bytes
  int n;
};

struct AdamScalars {
  const int* count;                 // the steps taken, this one included
  float b1, c1, b2, c2, eps;        // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, float lr,
                                         float bc1, float bc2, const AdamScalars& s) {
  m = __fmaf_rn(s.c1, g, __fmul_rn(m, s.b1));
  v = __fmaf_rn(__fmul_rn(s.c2, g), g, __fmul_rn(v, s.b2));
  const float num = __fmul_rn(lr, __fdiv_rn(m, bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ AdamTensors t, const AdamScalars s) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= t.end[t.n - 1]) return;
  int i = 0;
  while (c >= t.end[i]) ++i;
  float* p = t.p[i];
  const float* g = t.g[i];
  float* m = t.m[i];
  float* v = t.v[i];
  const long long size = t.size[i];
  const long long e = 4 * (c - (i ? t.end[i - 1] : 0));
  const float lr = t.lr_at[i] ? *t.lr_at[i] : t.lr[i];
  const float step = static_cast<float>(*s.count);
  const float bc1 = __fsub_rn(1.0f, powf(s.b1, step));
  const float bc2 = __fsub_rn(1.0f, powf(s.b2, step));
  if (((t.aligned >> i) & 1u) && e + 4 <= size) {
    float4 p4 = *reinterpret_cast<const float4*>(p + e);
    float4 m4 = *reinterpret_cast<const float4*>(m + e);
    float4 v4 = *reinterpret_cast<const float4*>(v + e);
    const float4 g4 = g ? *reinterpret_cast<const float4*>(g + e)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    adam_one(p4.x, g4.x, m4.x, v4.x, lr, bc1, bc2, s);
    adam_one(p4.y, g4.y, m4.y, v4.y, lr, bc1, bc2, s);
    adam_one(p4.z, g4.z, m4.z, v4.z, lr, bc1, bc2, s);
    adam_one(p4.w, g4.w, m4.w, v4.w, lr, bc1, bc2, s);
    *reinterpret_cast<float4*>(p + e) = p4;
    *reinterpret_cast<float4*>(m + e) = m4;
    *reinterpret_cast<float4*>(v + e) = v4;
  } else {
    const long long last = e + 4 < size ? e + 4 : size;
    for (long long k = e; k < last; ++k)
      adam_one(p[k], g ? g[k] : 0.0f, m[k], v[k], lr, bc1, bc2, s);
  }
}

bool on16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15u) == 0; }

}  // namespace

// One Adam step on `stream` over n tensors (1 to kMaxTensors), each of
// sizes[i] float32s: arrays[4 i .. 4 i + 3] are its parameter, gradient (NULL
// for none), first and second moments, contiguous; its learning rate is
// *lr_at[i] (a float32 on the device) or, where lr_at[i] is NULL, lrs[i].
// count: the int32 step count on the device, already advanced for this step.
// Launches nothing when the tensors hold no float. Returns cudaError_t.
extern "C" int adam_fused(int n, const long long* sizes, void* const* arrays,
                          void* const* lr_at, const float* lrs, const int* count, float b1,
                          float c1, float b2, float c2, float eps, void* stream) {
  if (n < 1 || n > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  AdamTensors t = {};
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    t.p[i] = static_cast<float*>(arrays[4 * i]);
    t.g[i] = static_cast<const float*>(arrays[4 * i + 1]);
    t.m[i] = static_cast<float*>(arrays[4 * i + 2]);
    t.v[i] = static_cast<float*>(arrays[4 * i + 3]);
    t.lr_at[i] = static_cast<const float*>(lr_at[i]);
    t.lr[i] = lrs[i];
    t.size[i] = sizes[i];
    chunks += (sizes[i] + 3) / 4;
    t.end[i] = chunks;
    if (on16(t.p[i]) && on16(t.g[i]) && on16(t.m[i]) && on16(t.v[i])) t.aligned |= 1u << i;
  }
  t.n = n;
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
  const AdamScalars s = {count, b1, c1, b2, c2, eps};
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}
