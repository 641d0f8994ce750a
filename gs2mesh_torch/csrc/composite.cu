// Kernels K2 (tile compositing, forward) and K3 (its backward).
//
// ---- K2 ----
//
// Replaces gs2mesh_tpu/ops/rasterizer/pallas_kernels.py::_forward_kernel
// (launched by _fwd_call). The TPU kernel streams a tile's depth-sorted pair
// chunks through VMEM and composites a whole 128-pair chunk at once with
// prefix-product scans and an MXU matmul. Here one 1024-thread block owns one
// 32x32 tile and each thread composites its own pixel sequentially, in the
// reference's (forward.cu renderCUDA) order:
//   skip a pair if alpha_raw < 1/255; alpha = min(0.99, alpha_raw);
//   stop BEFORE the first pair whose T * (1 - alpha) < 1e-4.
// The block streams its [start, start + count) sorted pairs in batches of
// `chunk`: the first `chunk` threads gather each pair's (mean, conic,
// opacity, rgb) by gaussian id from the (N, 9) feature rows into shared
// memory, then every thread walks the batch. The block exits as soon as all
// of its pixels are done (__syncthreads_count).
//
// Bound: operations. At the 300k-gaussian, 960x576 scene each (pair, pixel)
// evaluation costs ~12 FP32 ops and one expf, and there are far more
// evaluations than bytes to move (the feature gather is 36 bytes per pair per
// tile, shared by 1024 pixels). Design: the per-pair data sits in shared
// memory and is broadcast to all threads of a warp; the early exit cuts work
// once a tile is saturated.
//
// Numerics: alpha must decide `alpha_raw >= 1/255` exactly as the reference
// does, so the tile-local mean (mx - 32*tx), dx/dy and the power
// (-0.5*ca)*(dx*dx) + dy*((-0.5*cc)*dy - cb*dx) are separately rounded
// __f*_rn ops in the reference's order (the build also passes -fmad=false),
// and expf is the full-precision one.

// ---- K3 ----
//
// Replaces gs2mesh_tpu/ops/rasterizer/pallas_kernels.py::_backward_kernel in
// both of its layouts (positional, launched by _bwd_call, and compact,
// _backward_kernel_compact launched by bwd_call_compact): the two differ only
// in where they write, and K3 writes each pair's gradient at its emission
// slot order[s], so it needs neither the zero-fill of skipped chunks nor the
// append counter and the ids carried in mantissa bits. K4 (segsum.cu) then
// sums each gaussian's contiguous slot segment.
//
// Same block layout as K2 and the same forward-order replay as the TPU
// kernel: one 1024-thread block per 32x32 tile, one thread per pixel, the
// pairs staged kBatch at a time in shared memory, the alpha / 1/255 skip /
// T-stop decisions made by the same __device__ code as K2 (so they match
// the forward bit for bit). Per accepted pair and pixel, with
// U_tot = sum_c color_c*dC_c + dTf*T_final and U_run the inclusive prefix of
// u*w (u = rgb . dC):
//   dalpha = u*T - (U_tot - U_run) / (1 - alpha),  dpower = dalpha*alpha_raw
// (no gate on the 0.99 clamp, as in the reference backward), then the 9
// gradients [d mean x, y, conic a, b, c, opacity, r, g, b]. Each pair's 9
// values are reduced over the tile's 1024 pixels deterministically, with no
// float atomics: a warp-shuffle tree per warp (skipped when no lane of the
// warp accepted the pair), per-warp partials in shared memory
// (kBatch x 9 x 32 floats = 36 KB), then a fixed-order sum over the 32
// warps. The same inputs give the same bits on every run.
//
// Bound: operations, like K2 (the replay repeats K2's per-evaluation work
// and adds the gradient terms and the reductions).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;     // K3 pairs per shared-memory batch
constexpr int kCols = 9;
constexpr unsigned kFull = 0xffffffffu;

// Stages pair row f (GLOBAL mean) for a tile with origin (ox, oy):
// geo = (tile-local mean x, y, -0.5*ca, opacity), col = (cb, -0.5*cc, r, g).
__device__ __forceinline__ void stage_pair(const float* f, float ox, float oy,
                                           float4* geo, float4* col,
                                           float* blue) {
  *geo = make_float4(__fsub_rn(f[0], ox), __fsub_rn(f[1], oy), -0.5f * f[2],
                     f[5]);
  *col = make_float4(f[3], -0.5f * f[4], f[6], f[7]);
  *blue = f[8];
}

// alpha_raw = op * exp(power) of a staged pair at pixel (px, py), with the
// power (-0.5*ca)*(dx*dx) + dy*((-0.5*cc)*dy - cb*dx) in the reference's op
// order. Also returns dx, dy and G = exp(power).
__device__ __forceinline__ float pair_alpha_raw(const float4 a, const float4 b,
                                                float px, float py, float* dx,
                                                float* dy, float* G) {
  *dx = __fsub_rn(a.x, px);
  *dy = __fsub_rn(a.y, py);
  const float power =
      __fadd_rn(__fmul_rn(a.z, __fmul_rn(*dx, *dx)),
                __fmul_rn(*dy, __fsub_rn(__fmul_rn(b.y, *dy),
                                         __fmul_rn(b.x, *dx))));
  *G = expf(power);
  return __fmul_rn(a.w, *G);
}

__global__ void __launch_bounds__(kThreads) composite_forward_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ feat9,
    int width, int height, int gx, int chunk, float alpha_min,
    float alpha_clamp, float t_eps, float* __restrict__ color,
    float* __restrict__ final_T) {
  extern __shared__ float4 smem[];
  float4* s_geo = smem;           // tile-local mean x, y; -0.5*ca; opacity
  float4* s_col = smem + chunk;   // cb; -0.5*cc; r; g
  float* s_blue = reinterpret_cast<float*>(smem + 2 * chunk);

  const int t = blockIdx.x;
  const int tx = t % gx, ty = t / gx;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool in_image = x < width && y < height;
  const float px = (float)lx, py = (float)ly;
  const float ox = (float)(tx * kTile), oy = (float)(ty * kTile);
  const int start = starts[t], count = counts[t];

  float T = 1.0f, c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  bool done = !in_image;

  for (int base = 0; base < count; base += chunk) {
    // Also the barrier that keeps the previous batch alive until all read it.
    if (__syncthreads_count(done) == kThreads) break;
    const int j = threadIdx.x;
    if (j < chunk && base + j < count)
      stage_pair(feat9 + (int64_t)ids[start + base + j] * kCols, ox, oy,
                 &s_geo[j], &s_col[j], &s_blue[j]);
    __syncthreads();
    if (done) continue;
    const int n = min(chunk, count - base);
    for (int k = 0; k < n; ++k) {
      const float4 a = s_geo[k];
      const float4 b = s_col[k];
      float dx, dy, G;
      const float alpha_raw = pair_alpha_raw(a, b, px, py, &dx, &dy, &G);
      if (!(alpha_raw >= alpha_min)) continue;
      const float alpha = fminf(alpha_clamp, alpha_raw);
      const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_T < t_eps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
      c_r = __fadd_rn(c_r, __fmul_rn(b.z, w));
      c_g = __fadd_rn(c_g, __fmul_rn(b.w, w));
      c_b = __fadd_rn(c_b, __fmul_rn(s_blue[k], w));
      T = test_T;
    }
  }

  if (in_image) {
    const int64_t hw = (int64_t)width * height;
    const int64_t p = (int64_t)y * width + x;
    color[p] = c_r;
    color[hw + p] = c_g;
    color[2 * hw + p] = c_b;
    final_T[p] = T;
  }
}

__global__ void __launch_bounds__(kThreads) composite_backward_kernel(
    const int32_t* __restrict__ ids, const int64_t* __restrict__ order,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
    const float* __restrict__ feat9, const float* __restrict__ color,
    const float* __restrict__ final_T, const float* __restrict__ dcolor,
    const float* __restrict__ dfinal_T, int width, int height, int gx,
    float alpha_min, float alpha_clamp, float t_eps,
    float* __restrict__ dpairs) {
  __shared__ float4 s_geo[kBatch];
  __shared__ float4 s_col[kBatch];
  __shared__ float s_blue[kBatch];
  __shared__ float s_part[kBatch * kCols * kWarps];   // [pair][col][warp]

  const int t = blockIdx.x;
  const int tx = t % gx, ty = t / gx;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool in_image = x < width && y < height;
  const float px = (float)lx, py = (float)ly;
  const float ox = (float)(tx * kTile), oy = (float)(ty * kTile);
  const int start = starts[t], count = counts[t];

  float dCr = 0.0f, dCg = 0.0f, dCb = 0.0f, U_tot = 0.0f;
  if (in_image) {
    const int64_t hw = (int64_t)width * height;
    const int64_t p = (int64_t)y * width + x;
    dCr = dcolor[p];
    dCg = dcolor[hw + p];
    dCb = dcolor[2 * hw + p];
    U_tot = color[p] * dCr + color[hw + p] * dCg + color[2 * hw + p] * dCb +
            dfinal_T[p] * final_T[p];
  }
  float T = 1.0f, U_run = 0.0f;
  bool done = !in_image;

  for (int base = 0; base < count; base += kBatch) {
    // Also the barrier that keeps the previous batch (pairs and partials)
    // alive until every thread has read it.
    if (__syncthreads_count(done) == kThreads) break;
    const int j = threadIdx.x;
    if (j < kBatch && base + j < count)
      stage_pair(feat9 + (int64_t)ids[start + base + j] * kCols, ox, oy,
                 &s_geo[j], &s_col[j], &s_blue[j]);
    __syncthreads();
    const int n = min(kBatch, count - base);

    if (__all_sync(kFull, done)) {
      // Every pixel of this warp has stopped: its partials are zero.
      if (lane < n)
        for (int c = 0; c < kCols; ++c)
          s_part[(lane * kCols + c) * kWarps + warp] = 0.0f;
    } else {
      for (int k = 0; k < n; ++k) {
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = 0.0f;
        bool active = false;
        if (!done) {
          const float4 a = s_geo[k];
          const float4 b = s_col[k];
          float dx, dy, G;
          const float alpha_raw = pair_alpha_raw(a, b, px, py, &dx, &dy, &G);
          if (alpha_raw >= alpha_min) {
            const float alpha = fminf(alpha_clamp, alpha_raw);
            const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
            if (test_T < t_eps) {
              done = true;
            } else {
              active = true;
              const float w = alpha * T;
              const float u = b.z * dCr + b.w * dCg + s_blue[k] * dCb;
              U_run += u * w;
              const float dalpha = u * T - (U_tot - U_run) / (1.0f - alpha);
              const float dpower = dalpha * alpha_raw;
              v[0] = dpower * (2.0f * a.z * dx - b.x * dy);
              v[1] = dpower * (2.0f * b.y * dy - b.x * dx);
              v[2] = -0.5f * dpower * (dx * dx);
              v[3] = -dpower * (dx * dy);
              v[4] = -0.5f * dpower * (dy * dy);
              v[5] = dalpha * G;
              v[6] = w * dCr;
              v[7] = w * dCg;
              v[8] = w * dCb;
              T = test_T;
            }
          }
        }
        float* part = s_part + k * kCols * kWarps + warp;
        if (__any_sync(kFull, active)) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float s = v[c];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_down_sync(kFull, s, off);
            if (lane == 0) part[c * kWarps] = s;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[c * kWarps] = 0.0f;
        }
      }
    }
    __syncthreads();
    // Fixed-order sum of the 32 warp partials of each (pair, column).
    if (j < n * kCols) {
      const float* part = s_part + j * kWarps;
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += part[w];
      const int k = j / kCols, c = j % kCols;
      dpairs[order[start + base + k] * kCols + c] = s;
    }
  }
}

}  // namespace

extern "C" int gs_composite_forward(const void* ids, const void* starts,
                                    const void* counts, const void* feat9,
                                    int width, int height, int gx, int gy,
                                    int chunk, float alpha_min,
                                    float alpha_clamp, float t_eps,
                                    void* color, void* final_T, void* stream) {
  if (chunk < 1 || chunk > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)chunk * (2 * sizeof(float4) + sizeof(float));
  composite_forward_kernel<<<gx * gy, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)starts, (const int32_t*)counts,
      (const float*)feat9, width, height, gx, chunk, alpha_min, alpha_clamp,
      t_eps, (float*)color, (float*)final_T);
  return (int)cudaGetLastError();
}

extern "C" int gs_composite_backward(
    const void* ids, const void* order, const void* starts,
    const void* counts, const void* feat9, const void* color,
    const void* final_T, const void* dcolor, const void* dfinal_T, int width,
    int height, int gx, int gy, float alpha_min, float alpha_clamp,
    float t_eps, void* dpairs, void* stream) {
  composite_backward_kernel<<<gx * gy, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int64_t*)order, (const int32_t*)starts,
      (const int32_t*)counts, (const float*)feat9, (const float*)color,
      (const float*)final_T, (const float*)dcolor, (const float*)dfinal_T,
      width, height, gx, alpha_min, alpha_clamp, t_eps, (float*)dpairs);
  return (int)cudaGetLastError();
}
