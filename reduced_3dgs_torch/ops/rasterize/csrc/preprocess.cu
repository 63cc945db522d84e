// The per-Gaussian preprocess for NVIDIA Hopper (sm_90a): projection, EWA
// covariance, SH colour and tile rectangles (preprocess_fwd_kernel), and
// their gradients (preprocess_bwd_kernel, with camera_sum_kernel for the
// camera's).
//
// Replaces no Pallas kernel: the JAX package leaves this pass
// (reduced_3dgs_tpu/ops/rasterize/common.py:49-183) to XLA, which fuses it.
// In eager PyTorch the same code, common.preprocess_plain, is ~240 kernels
// forward and ~600 in its autograd, and those, with their launches, took
// more of a training step than the compositors. See
// reduced_3dgs_torch/ops/rasterize/preprocess_kernel.py for the contract,
// and for preprocess_fwd_plain and preprocess_bwd_plain, the plain PyTorch
// versions these kernels are held against (the backward's formulas are
// written there line for line).
//
// What bounds it on this card: bytes. The forward reads 236 B a Gaussian at
// SH degree 3 (means 12, opacity 4, scales 12, rotation 16, the [16,3] SH
// row 192) and writes 64 (the ten fields, radius, rects, tile count); the
// backward reads the same inputs and the 40-B field gradient and writes
// 244 B of gradients. Each does a few hundred float operations a Gaussian,
// ~100 times fewer than the card does in the time of its bytes.
//
// At 1,250,000 Gaussians (NVIDIA H100 80GB HBM3, 700 W; device time under
// torch.profiler with the L2 flushed) the forward takes 0.145 ms, 79% of its
// bytes' time at 3.35 TB/s, and the backward 0.408 ms, 48%.
//
// Design. One thread per Gaussian, float32 throughout, the camera read from
// device memory into shared memory by each block (so a captured graph reads
// the camera that its fixed tensors hold at replay). Each thread loads its
// SH row, 192 contiguous bytes at degree 3, as 128-bit loads when every row
// starts on 16 bytes, and the backward stores the SH gradient the same way.
// Staging each warp's 6 KB of rows through shared memory with coalesced
// loads instead was no faster (forward at 1.25M: 0.2005 ms against 0.1972,
// medians of six; equal at 200k), so the loads stay direct.
// The library is built with -fmad=false: every product and sum is rounded
// in the plain version's order, so the depth that decides the near cull,
// the radius and the tile rectangles are the plain version's bits but where
// a transcendental (exp, log, rsqrt) rounds differently. The backward
// recomputes what it needs from the inputs and saves nothing. The camera's
// gradient (35 floats) is summed per block, by warp shuffles and then over
// the block's warps in order, into a partial row per block; a second kernel
// sums the rows in a fixed order. So it repeats to the bit, and no thread
// contends on those 35 addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kCamera = 35;       // viewmatrix [16], projmatrix [16], campos [3]
constexpr int kFields = 10;
constexpr float kNearZ = 0.2f;
constexpr float kLowpass = 0.3f;
constexpr float kTile = 16.0f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f,
                             0.31539156525252005f, -1.0925484305920792f,
                             0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f,
                             -0.4570457994644658f, 0.3731763325901154f,
                             -0.4570457994644658f, 1.445305721320277f,
                             -0.5900435899266435f};

struct Geometry {
  int H, W, tiles_x, tiles_y;
  float fx, fy, lim_x, lim_y, modifier;
};

// The camera in shared memory: row-vector matrices, M[i][k] at M[4 i + k].
struct Camera {
  float V[16], P[16], c[3];
};

__device__ __forceinline__ void load_camera(Camera& cam, const float* view,
                                            const float* proj, const float* campos,
                                            int c_stride) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam.V[t] = view[t];
    cam.P[t] = proj[t];
  } else if (t < 19) {
    cam.c[t - 16] = campos[(t - 16) * c_stride];
  }
  __syncthreads();
}

// Column k of [p, 1] @ M, summed term by term in the plain version's order.
__device__ __forceinline__ float transform(const float* M, float x, float y, float z, int k) {
  return ((x * M[k] + y * M[4 + k]) + z * M[8 + k]) + M[12 + k];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The first kFloats floats of row i of a [N, stride] array, as float4 loads
// when `aligned` (every row starts on 16 bytes and stride % 4 == 0).
template <int kFloats>
__device__ __forceinline__ void load_row(const float* base, int stride, bool aligned, int i,
                                         float* out) {
  const float* row = base + static_cast<size_t>(i) * stride;
  if (aligned) {
    constexpr int kVec = (kFloats + 3) / 4;
    float buf[kVec * 4];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row) + v);
      buf[4 * v] = q.x;
      buf[4 * v + 1] = q.y;
      buf[4 * v + 2] = q.z;
      buf[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < kFloats; ++j) out[j] = buf[j];
  } else {
#pragma unroll
    for (int j = 0; j < kFloats; ++j) out[j] = __ldg(row + j);
  }
}

// Everything the two kernels derive from a Gaussian's position, shape and
// the camera before the colour: the plain version's quantities, op by op.
struct Projected {
  float t[3];             // view-space point
  bool in_front;          // view z > kNearZ (the near cull)
  float tz, inv, u, v;    // Jacobian's z (1 where culled), 1/tz, t_xy / tz
  float tx, ty;           // the clamped view x, y
  float j00, j02, j11, j12;
  float T0[3], T1[3];     // rows of J W
  float R[3][3], S[3];    // rotation, scale x modifier
  float RS[3][3];
  float Sig[3][3];        // world covariance
  float ST0[3], ST1[3];   // Sigma T0, Sigma T1
  float a, b, c, det;     // screen covariance (xx, xy, yy) and its determinant
};

__device__ __forceinline__ void project(const Camera& cam, const Geometry& g, float mx,
                                        float my, float mz, const float* q, const float* s,
                                        Projected& p) {
  const float* V = cam.V;
#pragma unroll
  for (int k = 0; k < 3; ++k) p.t[k] = transform(V, mx, my, mz, k);
  p.in_front = p.t[2] > kNearZ;
  p.tz = p.in_front ? p.t[2] : 1.0f;
  p.u = p.t[0] / p.tz;
  p.v = p.t[1] / p.tz;
  p.tx = clampf(p.u, -g.lim_x, g.lim_x) * p.tz;
  p.ty = clampf(p.v, -g.lim_y, g.lim_y) * p.tz;
  p.inv = 1.0f / p.tz;
  p.j00 = g.fx * p.inv;
  p.j02 = ((-g.fx * p.tx) * p.inv) * p.inv;
  p.j11 = g.fy * p.inv;
  p.j12 = ((-g.fy * p.ty) * p.inv) * p.inv;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.T0[k] = p.j00 * V[4 * k] + p.j02 * V[4 * k + 2];
    p.T1[k] = p.j11 * V[4 * k + 1] + p.j12 * V[4 * k + 2];
  }
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  p.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  p.R[0][1] = 2.0f * (x * y - r * z);
  p.R[0][2] = 2.0f * (x * z + r * y);
  p.R[1][0] = 2.0f * (x * y + r * z);
  p.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  p.R[1][2] = 2.0f * (y * z - r * x);
  p.R[2][0] = 2.0f * (x * z - r * y);
  p.R[2][1] = 2.0f * (y * z + r * x);
  p.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int j = 0; j < 3; ++j) p.S[j] = s[j] * g.modifier;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.RS[i][j] = p.R[i][j] * p.S[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.Sig[i][j] = dot3(p.RS[i], p.RS[j]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.ST0[i] = dot3(p.Sig[i], p.T0);
    p.ST1[i] = dot3(p.Sig[i], p.T1);
  }
  p.a = dot3(p.T0, p.ST0) + kLowpass;
  p.b = dot3(p.T0, p.ST1);
  p.c = dot3(p.T1, p.ST1) + kLowpass;
  p.det = p.a * p.c - p.b * p.b;
}

// The real SH basis of degree kDeg at a unit direction, sh.py's sh_basis.
template <int kDeg>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* B) {
  B[0] = kC0;
  if constexpr (kDeg > 0) {
    B[1] = -kC1 * y;
    B[2] = kC1 * z;
    B[3] = -kC1 * x;
  }
  if constexpr (kDeg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    B[4] = kC2[0] * xy;
    B[5] = kC2[1] * yz;
    B[6] = kC2[2] * ((2.0f * zz - xx) - yy);
    B[7] = kC2[3] * xz;
    B[8] = kC2[4] * (xx - yy);
    if constexpr (kDeg > 2) {
      B[9] = (kC3[0] * y) * (3.0f * xx - yy);
      B[10] = (kC3[1] * xy) * z;
      B[11] = (kC3[2] * y) * ((4.0f * zz - xx) - yy);
      B[12] = (kC3[3] * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      B[13] = (kC3[4] * x) * ((4.0f * zz - xx) - yy);
      B[14] = (kC3[5] * z) * (xx - yy);
      B[15] = (kC3[6] * x) * (xx - 3.0f * yy);
    }
  }
}

// Half-open tile rectangle of a centre and half-widths, tile_rect's
// rounding: min truncated, max floored plus one, both clipped in float.
__device__ __forceinline__ void tile_rect(float px, float py, float hx, float hy,
                                          const Geometry& g, int2& lo, int2& hi) {
  lo.x = static_cast<int>(clampf(truncf((px - hx) / kTile), 0.0f, g.tiles_x));
  lo.y = static_cast<int>(clampf(truncf((py - hy) / kTile), 0.0f, g.tiles_y));
  hi.x = static_cast<int>(clampf(floorf((px + hx) / kTile) + 1.0f, 0.0f, g.tiles_x));
  hi.y = static_cast<int>(clampf(floorf((py + hy) / kTile) + 1.0f, 0.0f, g.tiles_y));
}

// kDeg: the SH degree, or -1 for given colours.
template <int kDeg>
__global__ void __launch_bounds__(kBlock)
preprocess_fwd_kernel(int n, int sh_stride, bool aligned, const float* __restrict__ means,
                      const float* __restrict__ opac, const float* __restrict__ scales,
                      const float* __restrict__ rots, const float* __restrict__ shs,
                      const float* __restrict__ colors, const float* __restrict__ offset,
                      const float* view, const float* proj, const float* campos, int c_stride,
                      Geometry g,
                      float* __restrict__ fields, int* __restrict__ radii,
                      int2* __restrict__ rect_min, int2* __restrict__ rect_max,
                      int* __restrict__ tiles) {
  __shared__ Camera cam;
  load_camera(cam, view, proj, campos, c_stride);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;

  const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
  const float4 q4 = __ldg(reinterpret_cast<const float4*>(rots) + i);
  const float q[4] = {q4.x, q4.y, q4.z, q4.w};
  const float s[3] = {scales[3 * i], scales[3 * i + 1], scales[3 * i + 2]};
  Projected p;
  project(cam, g, mx, my, mz, q, s, p);

  // Screen centre.
  const float h0 = transform(cam.P, mx, my, mz, 0);
  const float h1 = transform(cam.P, mx, my, mz, 1);
  const float h3 = transform(cam.P, mx, my, mz, 3);
  const float pw = 1.0f / (h3 + 1e-7f);
  float nx = h0 * pw, ny = h1 * pw;
  if (offset != nullptr) {
    nx = nx + offset[2 * i];
    ny = ny + offset[2 * i + 1];
  }
  const float px = ((nx + 1.0f) * static_cast<float>(g.W) - 1.0f) * 0.5f;
  const float py = ((ny + 1.0f) * static_cast<float>(g.H) - 1.0f) * 0.5f;

  // Conic by the double-where inverse, and the 3-sigma radius.
  const bool nonzero = p.det != 0.0f;
  const float di = nonzero ? 1.0f / p.det : 0.0f;
  const float mid = 0.5f * (p.a + p.c);
  const float lam = mid + sqrtf(fmaxf(mid * mid - p.det, 0.1f));
  const float radius = ceilf(3.0f * sqrtf(lam));
  const float op = 1.0f / (1.0f + expf(-opac[i]));

  // Visibility by the 3-sigma rectangle; bins by the alpha contour's box.
  int2 lo, hi;
  tile_rect(px, py, radius, radius, g, lo, hi);
  const bool visible = p.in_front && nonzero &&
                       max(hi.x - lo.x, 0) * max(hi.y - lo.y, 0) > 0;
  const float t2 = fmaxf(2.0f * logf(255.0f * fmaxf(op, 1e-6f)), 0.0f);
  tile_rect(px, py, fminf(radius, sqrtf(t2 * fmaxf(p.a, 0.0f))),
            fminf(radius, sqrtf(t2 * fmaxf(p.c, 0.0f))), g, lo, hi);
  const int touched = max(hi.x - lo.x, 0) * max(hi.y - lo.y, 0);

  float rgb[3];
  if constexpr (kDeg < 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = colors[3 * i + ch];
  } else {
    constexpr int kCoeffs = (kDeg + 1) * (kDeg + 1);
    const float vx = mx - cam.c[0], vy = my - cam.c[1], vz = mz - cam.c[2];
    const float rs = rsqrtf(((vx * vx + vy * vy) + vz * vz) + 1e-16f);
    float B[kCoeffs];
    sh_basis<kDeg>(vx * rs, vy * rs, vz * rs, B);
    float sh[3 * kCoeffs];
    load_row<3 * kCoeffs>(shs, sh_stride, aligned, i, sh);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = B[0] * sh[ch];
#pragma unroll
      for (int k = 1; k < kCoeffs; ++k) acc = acc + B[k] * sh[3 * k + ch];
      rgb[ch] = fmaxf(acc + 0.5f, 0.0f);
    }
  }

  const float out[kFields] = {px, py, p.c * di, -p.b * di, p.a * di, op,
                              rgb[0], rgb[1], rgb[2], p.t[2]};
#pragma unroll
  for (int f = 0; f < kFields; ++f) fields[static_cast<size_t>(f) * n + i] = out[f];
  radii[i] = visible ? static_cast<int>(radius) : 0;
  rect_min[i] = lo;
  rect_max[i] = hi;
  tiles[i] = visible ? touched : 0;
}

// Warp-shuffle sum of v over the warp, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// kDeg as above; kCam: the camera's gradient is asked for.
template <int kDeg, bool kCam>
__global__ void __launch_bounds__(kBlock)
preprocess_bwd_kernel(int n, int sh_stride, bool aligned, const float* __restrict__ means,
                      const float* __restrict__ opac, const float* __restrict__ scales,
                      const float* __restrict__ rots, const float* __restrict__ shs,
                      const float* view, const float* proj, const float* campos, int c_stride,
                      Geometry g,
                      const float* __restrict__ g_fields, long long g_stride,
                      float* __restrict__ d_means, float* __restrict__ d_opac,
                      float* __restrict__ d_scales, float* __restrict__ d_rots,
                      float* __restrict__ d_shs, float* __restrict__ d_offset,
                      float* __restrict__ d_colors, float* __restrict__ cam_partial) {
  __shared__ Camera cam;
  load_camera(cam, view, proj, campos, c_stride);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // Per-thread camera terms; inactive threads add zeros to the block's sums.
  float dV[16], dP[16], dc[3];
  if constexpr (kCam) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dV[j] = dP[j] = 0.0f;
    dc[0] = dc[1] = dc[2] = 0.0f;
  }
  if (i < n) {
    float gf[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f) gf[f] = g_fields[f * g_stride + i];
    const float gx = gf[0], gy = gf[1], gA = gf[2], gB = gf[3], gC = gf[4];
    const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
    const float4 q4 = __ldg(reinterpret_cast<const float4*>(rots) + i);
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
    const float s[3] = {scales[3 * i], scales[3 * i + 1], scales[3 * i + 2]};
    Projected p;
    project(cam, g, mx, my, mz, q, s, p);
    const float* V = cam.V;
    const float* P = cam.P;
    const float m[3] = {mx, my, mz};

    // Screen centre: px = ((ndc_x + 1) W - 1) / 2, ndc = h_xy / (h_w + 1e-7).
    const float h0 = transform(P, mx, my, mz, 0);
    const float h1 = transform(P, mx, my, mz, 1);
    const float h3 = transform(P, mx, my, mz, 3);
    const float pw = 1.0f / (h3 + 1e-7f);
    const float dnx = gx * 0.5f * static_cast<float>(g.W);
    const float dny = gy * 0.5f * static_cast<float>(g.H);
    if (d_offset != nullptr) {
      d_offset[2 * i] = dnx;
      d_offset[2 * i + 1] = dny;
    }
    const float dh[4] = {dnx * pw, dny * pw, 0.0f, -(dnx * h0 + dny * h1) * pw * pw};

    // Conic (c, -b, a) / det, zero with no gradient where det == 0.
    const float di = p.det != 0.0f ? 1.0f / p.det : 0.0f;
    const float d_det = -((gA * p.c - gB * p.b) + gC * p.a) * di * di;
    const float da = gC * di + d_det * p.c;
    const float db = -gB * di - 2.0f * p.b * d_det;
    const float dcc = gA * di + d_det * p.a;

    // cov2d = (T0 Sig T0 + 0.3, T0 Sig T1, T1 Sig T1 + 0.3).
    float dT0[3], dT1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dT0[k] = 2.0f * da * p.ST0[k] + db * p.ST1[k];
      dT1[k] = db * p.ST0[k] + 2.0f * dcc * p.ST1[k];
    }
    const float dj00 = (dT0[0] * V[0] + dT0[1] * V[4]) + dT0[2] * V[8];
    const float dj02 = (dT0[0] * V[2] + dT0[1] * V[6]) + dT0[2] * V[10];
    const float dj11 = (dT1[0] * V[1] + dT1[1] * V[5]) + dT1[2] * V[9];
    const float dj12 = (dT1[0] * V[2] + dT1[1] * V[6]) + dT1[2] * V[10];
    const float d_tx = -g.fx * p.inv * p.inv * dj02;
    const float d_ty = -g.fy * p.inv * p.inv * dj12;
    const float d_inv = g.fx * dj00 + g.fy * dj11 -
                        2.0f * p.inv * (g.fx * p.tx * dj02 + g.fy * p.ty * dj12);
    // torch.clamp passes its gradient at the limits inclusive.
    const bool in_x = p.u >= -g.lim_x && p.u <= g.lim_x;
    const bool in_y = p.v >= -g.lim_y && p.v <= g.lim_y;
    const float du = in_x ? d_tx * p.tz : 0.0f;
    const float dv = in_y ? d_ty * p.tz : 0.0f;
    const float d_tz = -d_inv * p.inv * p.inv + d_tx * clampf(p.u, -g.lim_x, g.lim_x) +
                       d_ty * clampf(p.v, -g.lim_y, g.lim_y) -
                       (du * p.t[0] + dv * p.t[1]) * p.inv * p.inv;
    // Culled rows took z = 1 in the Jacobian; the depth row reaches z always.
    const float dt[3] = {du * p.inv, dv * p.inv, gf[9] + (p.in_front ? d_tz : 0.0f)};

    // Sigma = RS RS^T: dRS = (dSig + dSig^T) RS.
    float Msym[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        Msym[a][l] = 2.0f * da * p.T0[a] * p.T0[l] + db * (p.T0[a] * p.T1[l] + p.T1[a] * p.T0[l]) +
                     2.0f * dcc * p.T1[a] * p.T1[l];
      }
    }
    float dR[3][3];
    float dS[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float dRS = (Msym[a][0] * p.RS[0][j] + Msym[a][1] * p.RS[1][j]) +
                          Msym[a][2] * p.RS[2][j];
        dS[j] += dRS * p.R[a][j];
        dR[a][j] = dRS * p.S[j];
      }
    }
    if (d_scales != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) d_scales[3 * i + j] = dS[j] * g.modifier;
    }
    if (d_rots != nullptr) {
      const float r = q[0], x = q[1], y = q[2], z = q[3];
      float4 dq;
      dq.x = 2.0f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] -
                     y * dR[2][0] + x * dR[2][1]);
      dq.y = 2.0f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] - 2.0f * x * dR[1][1] -
                     r * dR[1][2] + z * dR[2][0] + r * dR[2][1] - 2.0f * x * dR[2][2]);
      dq.z = 2.0f * (-2.0f * y * dR[0][0] + x * dR[0][1] + r * dR[0][2] + x * dR[1][0] +
                     z * dR[1][2] - r * dR[2][0] + z * dR[2][1] - 2.0f * y * dR[2][2]);
      dq.w = 2.0f * (-2.0f * z * dR[0][0] - r * dR[0][1] + x * dR[0][2] + r * dR[1][0] -
                     2.0f * z * dR[1][1] + y * dR[1][2] + x * dR[2][0] + y * dR[2][1]);
      reinterpret_cast<float4*>(d_rots)[i] = dq;
    }
    if (d_opac != nullptr) {
      const float op = 1.0f / (1.0f + expf(-opac[i]));
      d_opac[i] = gf[5] * op * (1.0f - op);
    }

    // Colour: SH at the view direction, + 0.5, maximum(., 0) (1/2 at 0).
    float dvec[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kDeg < 0) {
      if (d_colors != nullptr) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) d_colors[3 * i + ch] = gf[6 + ch];
      }
    } else {
      constexpr int kCoeffs = (kDeg + 1) * (kDeg + 1);
      const float vec[3] = {mx - cam.c[0], my - cam.c[1], mz - cam.c[2]};
      const float rs = rsqrtf(((vec[0] * vec[0] + vec[1] * vec[1]) + vec[2] * vec[2]) + 1e-16f);
      const float x = vec[0] * rs, y = vec[1] * rs, z = vec[2] * rs;
      float B[kCoeffs];
      sh_basis<kDeg>(x, y, z, B);
      float dB[kCoeffs];
      float d_pre[3];
      {
        float sh[3 * kCoeffs];
        load_row<3 * kCoeffs>(shs, sh_stride, aligned, i, sh);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = B[0] * sh[ch];
#pragma unroll
          for (int k = 1; k < kCoeffs; ++k) acc = acc + B[k] * sh[3 * k + ch];
          const float pre = acc + 0.5f;
          const float gc = gf[6 + ch];
          d_pre[ch] = pre > 0.0f ? gc : (pre == 0.0f ? 0.5f * gc : 0.0f);
        }
#pragma unroll
        for (int k = 0; k < kCoeffs; ++k) {
          dB[k] = (sh[3 * k] * d_pre[0] + sh[3 * k + 1] * d_pre[1]) + sh[3 * k + 2] * d_pre[2];
        }
      }
      if (d_shs != nullptr) {
        // The degree's coefficients, then zeros to the row's end.
        constexpr int kVec = (3 * kCoeffs + 3) / 4;
        float buf[4 * kVec];
#pragma unroll
        for (int k = 0; k < kCoeffs; ++k) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) buf[3 * k + ch] = B[k] * d_pre[ch];
        }
#pragma unroll
        for (int j = 3 * kCoeffs; j < 4 * kVec; ++j) buf[j] = 0.0f;
        float* row = d_shs + static_cast<size_t>(i) * sh_stride;
        if (aligned) {
          float4* row4 = reinterpret_cast<float4*>(row);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            row4[v] = make_float4(buf[4 * v], buf[4 * v + 1], buf[4 * v + 2], buf[4 * v + 3]);
          }
          for (int v = kVec; v < sh_stride / 4; ++v) row4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int j = 0; j < 3 * kCoeffs; ++j) row[j] = buf[j];
          for (int j = 3 * kCoeffs; j < sh_stride; ++j) row[j] = 0.0f;
        }
      }
      if constexpr (kDeg > 0) {
        float gx3 = -kC1 * dB[3], gy3 = -kC1 * dB[1], gz3 = kC1 * dB[2];
        if constexpr (kDeg > 1) {
          const float xx = x * x, yy = y * y, zz = z * z;
          gx3 += kC2[0] * y * dB[4] - 2.0f * kC2[2] * x * dB[6] + kC2[3] * z * dB[7] +
                 2.0f * kC2[4] * x * dB[8];
          gy3 += kC2[0] * x * dB[4] + kC2[1] * z * dB[5] - 2.0f * kC2[2] * y * dB[6] -
                 2.0f * kC2[4] * y * dB[8];
          gz3 += kC2[1] * y * dB[5] + 4.0f * kC2[2] * z * dB[6] + kC2[3] * x * dB[7];
          if constexpr (kDeg > 2) {
            gx3 += kC3[0] * 6.0f * x * y * dB[9] + kC3[1] * y * z * dB[10] -
                   kC3[2] * 2.0f * x * y * dB[11] - kC3[3] * 6.0f * x * z * dB[12] +
                   kC3[4] * (4.0f * zz - 3.0f * xx - yy) * dB[13] +
                   kC3[5] * 2.0f * x * z * dB[14] + kC3[6] * 3.0f * (xx - yy) * dB[15];
            gy3 += kC3[0] * 3.0f * (xx - yy) * dB[9] + kC3[1] * x * z * dB[10] +
                   kC3[2] * (4.0f * zz - xx - 3.0f * yy) * dB[11] -
                   kC3[3] * 6.0f * y * z * dB[12] - kC3[4] * 2.0f * x * y * dB[13] -
                   kC3[5] * 2.0f * y * z * dB[14] - kC3[6] * 6.0f * x * y * dB[15];
            gz3 += kC3[1] * x * y * dB[10] + kC3[2] * 8.0f * y * z * dB[11] +
                   kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * dB[12] +
                   kC3[4] * 8.0f * x * z * dB[13] + kC3[5] * (xx - yy) * dB[14];
          }
        }
        // dirs = vec rsqrt(|vec|^2 + eps^2).
        const float ddv = (gx3 * vec[0] + gy3 * vec[1]) + gz3 * vec[2];
        const float rs3 = rs * rs * rs;
        dvec[0] = rs * gx3 - ddv * rs3 * vec[0];
        dvec[1] = rs * gy3 - ddv * rs3 * vec[1];
        dvec[2] = rs * gz3 - ddv * rs3 * vec[2];
      }
    }

    if (d_means != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        d_means[3 * i + a] = dvec[a] +
                             (((dh[0] * P[4 * a] + dh[1] * P[4 * a + 1]) + dh[3] * P[4 * a + 3]) +
                              ((dt[0] * V[4 * a] + dt[1] * V[4 * a + 1]) + dt[2] * V[4 * a + 2]));
      }
    }
    if constexpr (kCam) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int a = 0; a < 3; ++a) dV[4 * a + k] += dt[k] * m[a];
        dV[12 + k] = dt[k];
        dV[4 * k] += dT0[k] * p.j00;
        dV[4 * k + 1] += dT1[k] * p.j11;
        dV[4 * k + 2] += dT0[k] * p.j02 + dT1[k] * p.j12;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c == 2) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) dP[4 * a + c] = dh[c] * m[a];
        dP[12 + c] = dh[c];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) dc[a] = -dvec[a];
    }
  }
  if constexpr (kCam) {
    // The block's sums: each warp's by shuffles, then the warps' in order.
    __shared__ float warp_sums[kWarps][kCamera];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < kCamera; ++j) {
      const float v = warp_sum(j < 16 ? dV[j] : (j < 32 ? dP[j - 16] : dc[j - 32]));
      if (lane == 0) warp_sums[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kCamera) {
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += warp_sums[w][threadIdx.x];
      cam_partial[static_cast<size_t>(blockIdx.x) * kCamera + threadIdx.x] = acc;
    }
  }
}

// out[j] = sum over the rows of partial [rows, 35] of column j, one block
// per column, in a fixed order: each thread sums a strided set of rows in
// order, then the block halves its sums in a fixed tree.
__global__ void __launch_bounds__(256)
camera_sum_kernel(const float* __restrict__ partial, int rows, float* __restrict__ out) {
  __shared__ float sums[256];
  const int j = blockIdx.x;
  float acc = 0.0f;
  for (int r = threadIdx.x; r < rows; r += 256) {
    acc += partial[static_cast<size_t>(r) * kCamera + j];
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = sums[0];
}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

template <int kDeg>
int launch_fwd(int n, int sh_stride, int aligned, const float* means, const float* opac,
               const float* scales, const float* rots, const float* shs, const float* colors,
               const float* offset, const float* view, const float* proj,
               const float* campos, int c_stride, Geometry g, float* fields, int* radii,
               int* rect_min, int* rect_max, int* tiles, cudaStream_t stream) {
  preprocess_fwd_kernel<kDeg><<<blocks_for(n), kBlock, 0, stream>>>(
      n, sh_stride, aligned != 0, means, opac, scales, rots, shs, colors, offset, view, proj,
      campos, c_stride, g, fields, radii, reinterpret_cast<int2*>(rect_min),
      reinterpret_cast<int2*>(rect_max), tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kDeg, bool kCam>
int launch_bwd(int n, int sh_stride, int aligned, const float* means, const float* opac,
               const float* scales, const float* rots, const float* shs, const float* view,
               const float* proj, const float* campos, int c_stride, Geometry g,
               const float* g_fields, long long g_stride, float* d_means, float* d_opac,
               float* d_scales, float* d_rots, float* d_shs, float* d_offset, float* d_colors,
               float* cam_partial, float* cam_out, cudaStream_t stream) {
  const int blocks = blocks_for(n);
  preprocess_bwd_kernel<kDeg, kCam><<<blocks, kBlock, 0, stream>>>(
      n, sh_stride, aligned != 0, means, opac, scales, rots, shs, view, proj, campos, c_stride,
      g, g_fields, g_stride, d_means, d_opac, d_scales, d_rots, d_shs, d_offset, d_colors,
      cam_partial);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !kCam) return err;
  camera_sum_kernel<<<kCamera, 256, 0, stream>>>(cam_partial, blocks, cam_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCam>
int dispatch_bwd(int degree, int n, int sh_stride, int aligned, const float* means,
                 const float* opac, const float* scales, const float* rots, const float* shs,
                 const float* view, const float* proj, const float* campos, int c_stride,
                 Geometry g, const float* g_fields, long long g_stride, float* d_means,
                 float* d_opac,
                 float* d_scales, float* d_rots, float* d_shs, float* d_offset,
                 float* d_colors, float* cam_partial, float* cam_out, cudaStream_t stream) {
#define R3DGS_BWD(D)                                                                     \
  launch_bwd<D, kCam>(n, sh_stride, aligned, means, opac, scales, rots, shs, view, proj, \
                      campos, c_stride, g, g_fields, g_stride, d_means, d_opac,          \
                      d_scales, d_rots, d_shs, d_offset, d_colors, cam_partial,          \
                      cam_out, stream)
  switch (degree) {
    case -1: return R3DGS_BWD(-1);
    case 0: return R3DGS_BWD(0);
    case 1: return R3DGS_BWD(1);
    case 2: return R3DGS_BWD(2);
    case 3: return R3DGS_BWD(3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef R3DGS_BWD
}

}  // namespace

// Launches the forward kernel on `stream` and returns cudaGetLastError() (0
// on success). n Gaussians; degree: the SH degree 0-3, or -1 to take
// `colors` [n,3] as the colour (shs unread); shs: [n, sh_stride / 3, 3] with
// sh_stride / 3 >= (degree+1)^2 coefficients; aligned: every SH row starts
// on 16 bytes and sh_stride % 4 == 0. means, scales [n,3]; opac [n]; rots
// [n,4] (r, x, y, z), 16-byte aligned; offset [n,2] or null; view, proj
// [4,4] row-vector storage and campos [3] (element i at campos[i *
// c_stride]), on the device. H, W: the image; tiles_x, tiles_y: its tile
// grid; fx, fy: focal lengths; lim_x, lim_y: 1.3 tan(FoV/2); modifier: the
// scale modifier. Writes fields [10, n] (x, y,
// conic A, B, C, opacity, r, g, b, depth), radii [n], rect_min and rect_max
// [n, 2] and tiles [n], int32.
extern "C" int preprocess_fwd(int n, int degree, int sh_stride, int aligned,
                              const float* means, const float* opac, const float* scales,
                              const float* rots, const float* shs, const float* colors,
                              const float* offset, const float* view, const float* proj,
                              const float* campos, int c_stride, int H, int W, int tiles_x,
                              int tiles_y, float fx, float fy, float lim_x, float lim_y,
                              float modifier, float* fields, int* radii, int* rect_min,
                              int* rect_max, int* tiles, void* stream) {
  if (n <= 0) return 0;
  const Geometry g{H, W, tiles_x, tiles_y, fx, fy, lim_x, lim_y, modifier};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R3DGS_FWD(D)                                                                  \
  launch_fwd<D>(n, sh_stride, aligned, means, opac, scales, rots, shs, colors, offset, \
                view, proj, campos, c_stride, g, fields, radii, rect_min, rect_max, tiles, s)
  switch (degree) {
    case -1: return R3DGS_FWD(-1);
    case 0: return R3DGS_FWD(0);
    case 1: return R3DGS_FWD(1);
    case 2: return R3DGS_FWD(2);
    case 3: return R3DGS_FWD(3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef R3DGS_FWD
}

// Launches the backward kernel on `stream` (and, when cam_out is not null,
// the camera's sum after it) and returns cudaGetLastError(). The inputs are
// preprocess_fwd's (without colors and offset); g_fields: the gradient of
// fields, row f at g_fields + f * g_stride. Each gradient pointer may be
// null (not asked for): d_means, d_scales [n,3]; d_opac [n]; d_rots [n,4],
// 16-byte aligned; d_shs [n, sh_stride / 3, 3], written whole (zeros past
// the degree's coefficients); d_offset [n,2]; d_colors [n,3]. cam_partial:
// [ceil(n / 128), 35] scratch, and cam_out [35] the camera's gradient
// (viewmatrix [16], projmatrix [16], campos [3]), both null unless asked for.
extern "C" int preprocess_bwd(int n, int degree, int sh_stride, int aligned,
                              const float* means, const float* opac, const float* scales,
                              const float* rots, const float* shs, const float* view,
                              const float* proj, const float* campos, int c_stride, int H,
                              int W,
                              int tiles_x, int tiles_y, float fx, float fy, float lim_x,
                              float lim_y, float modifier, const float* g_fields,
                              long long g_stride, float* d_means, float* d_opac,
                              float* d_scales, float* d_rots, float* d_shs, float* d_offset,
                              float* d_colors, float* cam_partial, float* cam_out,
                              void* stream) {
  if (n <= 0) return 0;
  const Geometry g{H, W, tiles_x, tiles_y, fx, fy, lim_x, lim_y, modifier};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cam_out != nullptr) {
    return dispatch_bwd<true>(degree, n, sh_stride, aligned, means, opac, scales, rots, shs,
                              view, proj, campos, c_stride, g, g_fields, g_stride, d_means,
                              d_opac, d_scales, d_rots, d_shs, d_offset, d_colors, cam_partial,
                              cam_out, s);
  }
  return dispatch_bwd<false>(degree, n, sh_stride, aligned, means, opac, scales, rots, shs,
                             view, proj, campos, c_stride, g, g_fields, g_stride, d_means,
                             d_opac, d_scales, d_rots, d_shs, d_offset, d_colors, nullptr, nullptr,
                             s);
}
