// Kernel K2: tile compositing, forward.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;

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
    if (j < chunk && base + j < count) {
      const float* f = feat9 + (int64_t)ids[start + base + j] * 9;
      s_geo[j] = make_float4(__fsub_rn(f[0], ox), __fsub_rn(f[1], oy),
                             -0.5f * f[2], f[5]);
      s_col[j] = make_float4(f[3], -0.5f * f[4], f[6], f[7]);
      s_blue[j] = f[8];
    }
    __syncthreads();
    if (done) continue;
    const int n = min(chunk, count - base);
    for (int k = 0; k < n; ++k) {
      const float4 a = s_geo[k];
      const float4 b = s_col[k];
      const float dx = __fsub_rn(a.x, px);
      const float dy = __fsub_rn(a.y, py);
      const float power =
          __fadd_rn(__fmul_rn(a.z, __fmul_rn(dx, dx)),
                    __fmul_rn(dy, __fsub_rn(__fmul_rn(b.y, dy),
                                            __fmul_rn(b.x, dx))));
      const float alpha_raw = __fmul_rn(a.w, expf(power));
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
