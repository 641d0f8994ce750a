// Kernels P1 and P2: the per-gaussian preprocess (projection, EWA splat,
// conic, radius, tile rect, SH colour) and its backward.
//
// No TPU kernel is replaced: the JAX package leaves this jnp code
// (gs2mesh_tpu/ops/rasterizer/preprocess.py::preprocess) to XLA, which
// fuses it under jit. Eager PyTorch launches each of its ~150 elementwise
// ops over (N,) channels, and autograd replays each backwards, so the plain
// version (preprocess.py::preprocess_plain) costs some hundreds of launches
// a training step. The reference CUDA rasterizer has the same work as
// forward.cu::preprocessCUDA and backward.cu::preprocessCUDA +
// computeCov2DCUDA + computeColorFromSH.
//
// Bound: bytes. P1 reads 14 floats a gaussian plus its SH row (3K) and
// writes 16 values; P2 reads 18 floats plus the SH row and writes 10 plus
// the SH row. Each does some hundreds of float ops a gaussian, under the
// byte bound at the FP32 peak.
//
// Design: one thread per gaussian, 128 threads a block, every
// intermediate in registers; P2 recomputes the forward's intermediates from
// the inputs instead of reading them back. No atomics and no shared state:
// each run is bit-identical to the last. The camera (world_view, full_proj,
// cam_center, tan_fovx / tan_fovy) is read from device memory by every
// thread (the same addresses: served by the cache), so the wrapper reads
// nothing on the host.
//
// Numerics: the pair-deciding outputs (means2d, depths, conic, radius,
// rect, tiles_touched) must equal preprocess_plain's on the card bit for
// bit, so every expression here repeats the plain version's op order with
// one rounding per PyTorch op (the build passes -fmad=false): a Python
// scalar is rounded to float as TensorIterator rounds it; ``1.0 / x`` is
// PyTorch's reciprocal (an IEEE division); ``x ** 2`` is ``x * x``;
// ``v / tile`` is PyTorch's product with the scalar's reciprocal;
// minimum / maximum / clamp propagate NaN as PyTorch's do. rgb may differ
// in the last bits: PyTorch reduces the direction's norm its own way. P2
// repeats preprocess_backward_plain's op order in the same way.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// SH constants as gs2mesh_torch/core/sh.py holds them (doubles).
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792, kC2_1 = -1.0925484305920792,
                 kC2_2 = 0.31539156525252005, kC2_3 = -1.0925484305920792,
                 kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435, kC3_1 = 2.890611442640554,
                 kC3_2 = -0.4570457994644658, kC3_3 = 0.3731763325901154,
                 kC3_4 = -0.4570457994644658, kC3_5 = 1.445305721320277,
                 kC3_6 = -0.5900435899266435;

// A Python scalar as TensorIterator rounds it for a float tensor.
__device__ __forceinline__ float f(double v) { return (float)v; }

// PyTorch's NaN-propagating maximum / minimum / clamp_min / clamp.
__device__ __forceinline__ float t_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float t_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// PyTorch's reciprocal (``1.0 / x``): an IEEE division.
__device__ __forceinline__ float recip(float v) { return __fdiv_rn(1.0f, v); }

struct Cam {
  float W[16], P[16], C[3];
  float tanx, tany;
};

__device__ __forceinline__ void load_cam(Cam& c, const float* wv,
                                         const float* fp, const float* cc,
                                         const float* tx, const float* ty) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c.W[i] = __ldg(wv + i);
    c.P[i] = __ldg(fp + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) c.C[i] = __ldg(cc + i);
  c.tanx = __ldg(tx);
  c.tany = __ldg(ty);
}

struct Inputs {
  int n, K, deg, width, height;
  float scale_modifier, near, fov_clamp, dilation;
};

// The forward's float intermediates (preprocess.py::_terms), and the
// rotation and squared scales they were built from.
struct Terms {
  float R[3][3], s[3], s2[3];
  float view_x, view_y, depth, clip_x, clip_y, clip_w, p_w;
  bool valid;
  float fx, fy, tz, inv_tz, limx, limy, ux, uy, mx, my, txz, tyz;
  float a0, c0, a1, c1;
  float w[3][3];          // w[i] = (W3[i, 0], W3[i, 1], W3[i, 2])
  float q[6];             // q00 q01 q02 q11 q12 q22
  float cov_a, cov_b, cov_c, det, inv_det;
};

__device__ __forceinline__ float affine(const float* M, int k, float mx,
                                        float my, float mz) {
  return mx * M[k] + my * M[4 + k] + mz * M[8 + k] + M[12 + k];
}

__device__ __forceinline__ float qform(const float* wa, const float* wb,
                                       const float* sig) {
  // sig: sxx sxy sxz syy syz szz
  return wa[0] * wb[0] * sig[0] + wa[1] * wb[1] * sig[3] +
         wa[2] * wb[2] * sig[5] + (wa[0] * wb[1] + wa[1] * wb[0]) * sig[1] +
         (wa[0] * wb[2] + wa[2] * wb[0]) * sig[2] +
         (wa[1] * wb[2] + wa[2] * wb[1]) * sig[4];
}

__device__ __forceinline__ void terms(Terms& t, const Cam& c,
                                      const Inputs& in, const float* m,
                                      const float* sc, const float* q) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  // _rot_rows: 1 - 2 * (...), 2 * (...)
  t.R[0][0] = 1.0f - (y * y + z * z) * 2.0f;
  t.R[0][1] = (x * y - r * z) * 2.0f;
  t.R[0][2] = (x * z + r * y) * 2.0f;
  t.R[1][0] = (x * y + r * z) * 2.0f;
  t.R[1][1] = 1.0f - (x * x + z * z) * 2.0f;
  t.R[1][2] = (y * z - r * x) * 2.0f;
  t.R[2][0] = (x * z - r * y) * 2.0f;
  t.R[2][1] = (y * z + r * x) * 2.0f;
  t.R[2][2] = 1.0f - (x * x + y * y) * 2.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.s[k] = sc[k] * in.scale_modifier;
    t.s2[k] = t.s[k] * t.s[k];
  }
  float sig[6];
  const int kk[6] = {0, 0, 0, 1, 1, 2}, ll[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int k = kk[e], l = ll[e];
    sig[e] = t.R[k][0] * t.R[l][0] * t.s2[0] +
             t.R[k][1] * t.R[l][1] * t.s2[1] +
             t.R[k][2] * t.R[l][2] * t.s2[2];
  }

  const float mx = m[0], my = m[1], mz = m[2];
  t.view_x = affine(c.W, 0, mx, my, mz);
  t.view_y = affine(c.W, 1, mx, my, mz);
  t.depth = affine(c.W, 2, mx, my, mz);
  t.clip_x = affine(c.P, 0, mx, my, mz);
  t.clip_y = affine(c.P, 1, mx, my, mz);
  t.clip_w = affine(c.P, 3, mx, my, mz);
  t.p_w = recip(t.clip_w + f(1e-7));
  t.valid = t.depth > in.near;

  // focal = width / (2.0 * tan_fov): PyTorch's reciprocal times width.
  t.fx = recip(c.tanx * 2.0f) * (float)in.width;
  t.fy = recip(c.tany * 2.0f) * (float)in.height;
  t.tz = t.valid ? t.depth : 1.0f;
  t.inv_tz = recip(t.tz);
  t.limx = c.tanx * in.fov_clamp;
  t.limy = c.tany * in.fov_clamp;
  t.ux = t.view_x * t.inv_tz;
  t.uy = t.view_y * t.inv_tz;
  t.mx = t_min(t_max(t.ux, -t.limx), t.limx);
  t.my = t_min(t_max(t.uy, -t.limy), t.limy);
  t.txz = t.mx * t.tz;
  t.tyz = t.my * t.tz;

  t.a0 = t.fx * t.inv_tz;
  t.c0 = -t.fx * t.txz * t.inv_tz * t.inv_tz;
  t.a1 = t.fy * t.inv_tz;
  t.c1 = -t.fy * t.tyz * t.inv_tz * t.inv_tz;

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t.w[i][0] = c.W[i];
    t.w[i][1] = c.W[4 + i];
    t.w[i][2] = c.W[8 + i];
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) t.q[e] = qform(t.w[kk[e]], t.w[ll[e]], sig);
  const float a0 = t.a0, c0 = t.c0, a1 = t.a1, c1 = t.c1;
  const float q00 = t.q[0], q01 = t.q[1], q02 = t.q[2], q11 = t.q[3],
              q12 = t.q[4], q22 = t.q[5];
  t.cov_a = a0 * a0 * q00 + a0 * 2.0f * c0 * q02 + c0 * c0 * q22 + in.dilation;
  t.cov_b = a0 * a1 * q01 + a0 * c1 * q02 + c0 * a1 * q12 + c0 * c1 * q22;
  t.cov_c = a1 * a1 * q11 + a1 * 2.0f * c1 * q12 + c1 * c1 * q22 + in.dilation;
  t.det = t.cov_a * t.cov_c - t.cov_b * t.cov_b;
  t.inv_det = recip(t.det == 0.0f ? 1.0f : t.det);
}

// Unit view direction, and the unnormalised one and its norm.
__device__ __forceinline__ void sh_dirs(const Cam& c, const float* m,
                                        float* dir, float* d, float& n) {
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = m[j] - c.C[j];
  n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j) dir[j] = __fdiv_rn(d[j], n);
}

// core/sh.py::eval_sh for one colour channel of one gaussian; sh points at
// the channel's coefficient 0, the coefficients 3 floats apart.
__device__ __forceinline__ float eval_sh(int deg, const float* sh,
                                         const float* dir) {
  float res = sh[0] * f(kC0);
  if (deg > 0) {
    const float x = dir[0], y = dir[1], z = dir[2];
    res = res - (f(kC1) * y) * sh[3] + (f(kC1) * z) * sh[6] -
          (f(kC1) * x) * sh[9];
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      res = res + (f(kC2_0) * xy) * sh[12] + (f(kC2_1) * yz) * sh[15] +
            (f(kC2_2) * (zz * 2.0f - xx - yy)) * sh[18] +
            (f(kC2_3) * xz) * sh[21] + (f(kC2_4) * (xx - yy)) * sh[24];
      if (deg > 2) {
        res = res + (f(kC3_0) * y) * (xx * 3.0f - yy) * sh[27] +
              (f(kC3_1) * xy) * z * sh[30] +
              (f(kC3_2) * y) * (zz * 4.0f - xx - yy) * sh[33] +
              (f(kC3_3) * z) * (zz * 2.0f - xx * 3.0f - yy * 3.0f) * sh[36] +
              (f(kC3_4) * x) * (zz * 4.0f - xx - yy) * sh[39] +
              (f(kC3_5) * z) * (xx - yy) * sh[42] +
              (f(kC3_6) * x) * (xx - yy * 3.0f) * sh[45];
      }
    }
  }
  return res;
}

// The block's SH rows (row floats a gaussian) are staged in shared memory,
// where each takes row | 1 floats: an odd stride, so the 32 threads of a
// warp, each walking its own row, hit 32 banks. Element i of the block's
// rows in device memory sits at staged(i, row); the copies put
// neighbouring threads on neighbouring addresses in device memory.
__device__ __forceinline__ int staged(int i, int row) {
  const int r = i / row;
  return r * (row | 1) + (i - r * row);
}

__device__ __forceinline__ int block_floats(int row, int n) {
  return min(kThreads, n - (int)blockIdx.x * kThreads) * row;
}

__device__ __forceinline__ void load_rows(float* s, const float* src,
                                          int row, int n) {
  src += (int64_t)blockIdx.x * kThreads * row;
  for (int i = threadIdx.x; i < block_floats(row, n); i += kThreads)
    s[staged(i, row)] = src[i];
}

__device__ __forceinline__ void store_rows(float* dst, const float* s,
                                           int row, int n) {
  dst += (int64_t)blockIdx.x * kThreads * row;
  for (int i = threadIdx.x; i < block_floats(row, n); i += kThreads)
    dst[i] = s[staged(i, row)];
}

__device__ __forceinline__ int tile_edge(float v, float inv_tile, int hi) {
  return (int)clamp(floorf(v * inv_tile), 0.0f, (float)hi);
}

// Gaussian g's outputs; sh its SH row (coefficient k's channel c at
// sh[3 * k + c]).
__device__ __forceinline__ void forward_one(
    int g, const float* sh,
    const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations, const float* __restrict__ opacities,
    const float* __restrict__ wv,
    const float* __restrict__ fp, const float* __restrict__ cc,
    const float* __restrict__ tx, const float* __restrict__ ty, Inputs in,
    int tile, int gx, int gy, float* __restrict__ means2d,
    float* __restrict__ depths, float* __restrict__ conic,
    float* __restrict__ rgb, int32_t* __restrict__ radius,
    int32_t* __restrict__ rect, int32_t* __restrict__ tiles_touched) {
  Cam c;
  load_cam(c, wv, fp, cc, tx, ty);
  const float m[3] = {means3d[3 * g], means3d[3 * g + 1], means3d[3 * g + 2]};
  const float sc[3] = {scales[3 * g], scales[3 * g + 1], scales[3 * g + 2]};
  const float q[4] = {rotations[4 * g], rotations[4 * g + 1],
                      rotations[4 * g + 2], rotations[4 * g + 3]};
  Terms t;
  terms(t, c, in, m, sc, q);
  const float cov_a = t.cov_a, cov_b = t.cov_b, cov_c = t.cov_c, det = t.det;
  bool valid = t.valid && det != 0.0f;

  // Screen radius from the eigenvalues.
  const float mid = (cov_a + cov_c) * 0.5f;
  const float sq = sqrtf(clamp_min(mid * mid - det, f(0.1)));
  const float lambda_max = mid + sq;
  const float radius_f = ceilf(sqrtf(clamp_min(lambda_max, 0.0f)) * 3.0f);

  // Alpha-aware per-axis rect half-extents.
  const float op = opacities[g];
  const float log_term =
      clamp_min(logf(clamp_min(op * 255.0f, f(1e-12))), 0.0f);
  const float rx_cut = ceilf(sqrtf(clamp_min(cov_a, 0.0f) * 2.0f * log_term));
  const float ry_cut = ceilf(sqrtf(clamp_min(cov_c, 0.0f) * 2.0f * log_term));
  const float rect_rx = t_min(radius_f, rx_cut + 1.0f);
  const float rect_ry = t_min(radius_f, ry_cut + 1.0f);
  const bool emit_ok = op * f(1.02) >= f(1.0 / 255.0);

  const float mean_x =
      ((t.clip_x * t.p_w + 1.0f) * (float)in.width - 1.0f) * 0.5f;
  const float mean_y =
      ((t.clip_y * t.p_w + 1.0f) * (float)in.height - 1.0f) * 0.5f;

  const float tf = (float)tile, inv_tile = __fdiv_rn(1.0f, tf);
  const int x0 = tile_edge(mean_x - rect_rx, inv_tile, gx);
  const int y0 = tile_edge(mean_y - rect_ry, inv_tile, gy);
  const int x1 = tile_edge(mean_x + rect_rx + tf - 1.0f, inv_tile, gx);
  const int y1 = tile_edge(mean_y + rect_ry + tf - 1.0f, inv_tile, gy);
  const int tiles = (x1 - x0) * (y1 - y0);
  valid = valid && tiles > 0;

  float dir[3], d[3], n;
  sh_dirs(c, m, dir, d, n);
  float col[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    col[ch] = clamp_min(eval_sh(in.deg, sh + ch, dir) + 0.5f, 0.0f);

  reinterpret_cast<float2*>(means2d)[g] = make_float2(mean_x, mean_y);
  depths[g] = t.depth;
  conic[3 * g] = cov_c * t.inv_det;
  conic[3 * g + 1] = -cov_b * t.inv_det;
  conic[3 * g + 2] = cov_a * t.inv_det;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rgb[3 * g + ch] = col[ch];
  radius[g] = (int)(valid ? radius_f : 0.0f);
  reinterpret_cast<int4*>(rect)[g] = make_int4(x0, y0, x1, y1);
  tiles_touched[g] = (valid && emit_ok) ? tiles : 0;
}

__global__ void __launch_bounds__(kThreads) preprocess_forward_kernel(
    const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations, const float* __restrict__ opacities,
    const float* __restrict__ shs, const float* __restrict__ wv,
    const float* __restrict__ fp, const float* __restrict__ cc,
    const float* __restrict__ tx, const float* __restrict__ ty, Inputs in,
    int tile, int gx, int gy, float* __restrict__ means2d,
    float* __restrict__ depths, float* __restrict__ conic,
    float* __restrict__ rgb, int32_t* __restrict__ radius,
    int32_t* __restrict__ rect, int32_t* __restrict__ tiles_touched) {
  extern __shared__ float s_sh[];
  const int row = 3 * in.K;
  load_rows(s_sh, shs, row, in.n);
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < in.n)
    forward_one(g, s_sh + threadIdx.x * (row | 1), means3d, scales,
                rotations, opacities, wv, fp, cc, tx, ty, in, tile, gx, gy,
                means2d, depths, conic, rgb, radius, rect, tiles_touched);
}

// Autograd's gradient through minimum(maximum(u, -lim), lim) (ties split
// in halves) with respect to u.
__device__ __forceinline__ float min_max_grad(float g, float u, float lim) {
  const float v = t_max(u, -lim);
  g = v == lim ? g * 0.5f : g;
  if (v > lim) g = 0.0f;
  g = u == -lim ? g * 0.5f : g;
  if (u < -lim) g = 0.0f;
  return g;
}

// Gaussian g's gradients; sh its SH row, overwritten coefficient by
// coefficient (each read before it is written) with the row's gradient.
__device__ __forceinline__ void backward_one(
    int g, float* sh,
    const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations,
    const float* __restrict__ wv, const float* __restrict__ fp,
    const float* __restrict__ cc, const float* __restrict__ tx,
    const float* __restrict__ ty, const float* __restrict__ dmeans2d,
    const float* __restrict__ dconic, const float* __restrict__ drgb,
    Inputs in, float* __restrict__ g_means3d, float* __restrict__ g_scales,
    float* __restrict__ g_rotations) {
  Cam c;
  load_cam(c, wv, fp, cc, tx, ty);
  const float m[3] = {means3d[3 * g], means3d[3 * g + 1], means3d[3 * g + 2]};
  const float sc[3] = {scales[3 * g], scales[3 * g + 1], scales[3 * g + 2]};
  const float q[4] = {rotations[4 * g], rotations[4 * g + 1],
                      rotations[4 * g + 2], rotations[4 * g + 3]};
  Terms t;
  terms(t, c, in, m, sc, q);
  const float a0 = t.a0, c0 = t.c0, a1 = t.a1, c1 = t.c1;
  const float q00 = t.q[0], q01 = t.q[1], q02 = t.q[2], q11 = t.q[3],
              q12 = t.q[4], q22 = t.q[5];

  // conic = (cov_c, -cov_b, cov_a) / det
  const float gA = dconic[3 * g], gB = dconic[3 * g + 1],
              gC = dconic[3 * g + 2];
  const float g_inv = gA * t.cov_c - gB * t.cov_b + gC * t.cov_a;
  const float g_det =
      t.det == 0.0f ? 0.0f : -g_inv * (t.inv_det * t.inv_det);
  const float g_ca = gC * t.inv_det + g_det * t.cov_c;
  const float g_cb = -gB * t.inv_det - g_det * 2.0f * t.cov_b;
  const float g_cc = gA * t.inv_det + g_det * t.cov_a;

  // cov2d -> (a0, c0, a1, c1) and the six quadratic forms
  const float g_a0 = g_ca * (a0 * 2.0f * q00 + c0 * 2.0f * q02) +
                     g_cb * (a1 * q01 + c1 * q02);
  const float g_c0 = g_ca * (a0 * 2.0f * q02 + c0 * 2.0f * q22) +
                     g_cb * (a1 * q12 + c1 * q22);
  const float g_a1 = g_cc * (a1 * 2.0f * q11 + c1 * 2.0f * q12) +
                     g_cb * (a0 * q01 + c0 * q12);
  const float g_c1 = g_cc * (a1 * 2.0f * q12 + c1 * 2.0f * q22) +
                     g_cb * (a0 * q02 + c0 * q22);
  const float g_q[6] = {g_ca * a0 * a0,
                        g_cb * a0 * a1,
                        g_ca * 2.0f * a0 * c0 + g_cb * a0 * c1,
                        g_cc * a1 * a1,
                        g_cb * c0 * a1 + g_cc * 2.0f * a1 * c1,
                        g_ca * c0 * c0 + g_cb * c0 * c1 + g_cc * c1 * c1};

  // q_ij = w_i^T Sigma w_j -> the six covariance entries
  const int kk[6] = {0, 0, 0, 1, 1, 2}, ll[6] = {0, 1, 2, 1, 2, 2};
  float g_sig[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float* wa = t.w[kk[e]];
    const float* wb = t.w[ll[e]];
    const float coef[6] = {wa[0] * wb[0], wa[0] * wb[1] + wa[1] * wb[0],
                           wa[0] * wb[2] + wa[2] * wb[0], wa[1] * wb[1],
                           wa[1] * wb[2] + wa[2] * wb[1], wa[2] * wb[2]};
#pragma unroll
    for (int s = 0; s < 6; ++s)
      g_sig[s] = e == 0 ? g_q[e] * coef[s] : g_sig[s] + g_q[e] * coef[s];
  }
  const float g_xx = g_sig[0], g_xy = g_sig[1], g_xz = g_sig[2],
              g_yy = g_sig[3], g_yz = g_sig[4], g_zz = g_sig[5];

  // Sigma = R diag(s2) R^T -> R and the scales
  const float Gs[3][3] = {{g_xx * 2.0f, g_xy, g_xz},
                          {g_xy, g_yy * 2.0f, g_yz},
                          {g_xz, g_yz, g_zz * 2.0f}};
  float g_R[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g_R[k][j] = t.s2[j] * (Gs[k][0] * t.R[0][j] + Gs[k][1] * t.R[1][j] +
                             Gs[k][2] * t.R[2][j]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float R0 = t.R[0][j], R1 = t.R[1][j], R2 = t.R[2][j];
    const float g_s2 = g_xx * R0 * R0 + g_yy * R1 * R1 + g_zz * R2 * R2 +
                       g_xy * R0 * R1 + g_xz * R0 * R2 + g_yz * R1 * R2;
    g_scales[3 * g + j] = g_s2 * (t.s[j] * 2.0f) * in.scale_modifier;
  }

  // R(q) -> q (w, x, y, z)
  {
    const float r = q[0], x = q[1], y = q[2], z = q[3];
    const float g00 = g_R[0][0], g01 = g_R[0][1], g02 = g_R[0][2],
                g10 = g_R[1][0], g11 = g_R[1][1], g12 = g_R[1][2],
                g20 = g_R[2][0], g21 = g_R[2][1], g22 = g_R[2][2];
    const float gw = (-z * g01 + y * g02 + z * g10 - x * g12 - y * g20 +
                      x * g21) * 2.0f;
    const float gx = (y * g01 + z * g02 + y * g10 - x * 2.0f * g11 -
                      r * g12 + z * g20 + r * g21 - x * 2.0f * g22) * 2.0f;
    const float gy = (y * -2.0f * g00 + x * g01 + r * g02 + x * g10 +
                      z * g12 - r * g20 + z * g21 - y * 2.0f * g22) * 2.0f;
    const float gz = (z * -2.0f * g00 - r * g01 + x * g02 + r * g10 -
                      z * 2.0f * g11 + y * g12 + x * g20 + y * g21) * 2.0f;
    reinterpret_cast<float4*>(g_rotations)[g] = make_float4(gw, gx, gy, gz);
  }

  // (a0, c0, a1, c1) -> inv_tz, the clamped tangents and the view x / y
  const float fx = t.fx, fy = t.fy, inv_tz = t.inv_tz;
  const float g_txz = g_c0 * -fx * inv_tz * inv_tz;
  const float g_tyz = g_c1 * -fy * inv_tz * inv_tz;
  float g_inv_tz = g_a0 * fx + g_a1 * fy + g_c0 * -fx * t.txz * 2.0f * inv_tz +
                   g_c1 * -fy * t.tyz * 2.0f * inv_tz;
  const float g_ux = min_max_grad(g_txz * t.tz, t.ux, t.limx);
  const float g_uy = min_max_grad(g_tyz * t.tz, t.uy, t.limy);
  const float g_view_x = g_ux * inv_tz;
  const float g_view_y = g_uy * inv_tz;
  g_inv_tz = g_inv_tz + g_ux * t.view_x + g_uy * t.view_y;
  const float g_tz = g_txz * t.mx + g_tyz * t.my - g_inv_tz * (inv_tz * inv_tz);
  const float g_depth = t.valid ? g_tz : 0.0f;

  // means2d = ndc_to_pix(clip_xy * p_w)
  const float g_nx = dmeans2d[2 * g] * 0.5f * (float)in.width;
  const float g_ny = dmeans2d[2 * g + 1] * 0.5f * (float)in.height;
  const float g_pw = g_nx * t.clip_x + g_ny * t.clip_y;
  const float g_clip[3] = {g_nx * t.p_w, g_ny * t.p_w,
                           -g_pw * (t.p_w * t.p_w)};
  float g_m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    g_m[k] = c.W[4 * k] * g_view_x + c.W[4 * k + 1] * g_view_y +
             c.W[4 * k + 2] * g_depth + c.P[4 * k] * g_clip[0] +
             c.P[4 * k + 1] * g_clip[1] + c.P[4 * k + 3] * g_clip[2];

  // rgb = max(eval_sh(shs, dirs) + 0.5, 0)
  float dir[3], d[3], n;
  sh_dirs(c, m, dir, d, n);
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  // The basis as eval_sh multiplies it into each coefficient, and its
  // derivatives (0 where a term does not depend on the coordinate).
  float b[16], bx[16], by[16], bz[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = bx[k] = by[k] = bz[k] = 0.0f;
  b[0] = f(kC0);
  if (in.deg > 0) {
    b[1] = -(f(kC1) * y);
    b[2] = f(kC1) * z;
    b[3] = -(f(kC1) * x);
    bx[3] = f(-kC1);
    by[1] = f(-kC1);
    bz[2] = f(kC1);
  }
  if (in.deg > 1) {
    b[4] = f(kC2_0) * xy;
    b[5] = f(kC2_1) * yz;
    b[6] = f(kC2_2) * (zz * 2.0f - xx - yy);
    b[7] = f(kC2_3) * xz;
    b[8] = f(kC2_4) * (xx - yy);
    bx[4] = f(kC2_0) * y;
    bx[6] = f(-2.0 * kC2_2) * x;
    bx[7] = f(kC2_3) * z;
    bx[8] = f(2.0 * kC2_4) * x;
    by[4] = f(kC2_0) * x;
    by[5] = f(kC2_1) * z;
    by[6] = f(-2.0 * kC2_2) * y;
    by[8] = f(-2.0 * kC2_4) * y;
    bz[5] = f(kC2_1) * y;
    bz[6] = f(4.0 * kC2_2) * z;
    bz[7] = f(kC2_3) * x;
  }
  if (in.deg > 2) {
    b[9] = f(kC3_0) * y * (xx * 3.0f - yy);
    b[10] = f(kC3_1) * xy * z;
    b[11] = f(kC3_2) * y * (zz * 4.0f - xx - yy);
    b[12] = f(kC3_3) * z * (zz * 2.0f - xx * 3.0f - yy * 3.0f);
    b[13] = f(kC3_4) * x * (zz * 4.0f - xx - yy);
    b[14] = f(kC3_5) * z * (xx - yy);
    b[15] = f(kC3_6) * x * (xx - yy * 3.0f);
    bx[9] = f(6.0 * kC3_0) * xy;
    bx[10] = f(kC3_1) * yz;
    bx[11] = f(-2.0 * kC3_2) * xy;
    bx[12] = f(-6.0 * kC3_3) * xz;
    bx[13] = f(kC3_4) * (zz * 4.0f - xx * 3.0f - yy);
    bx[14] = f(2.0 * kC3_5) * xz;
    bx[15] = f(3.0 * kC3_6) * (xx - yy);
    by[9] = f(3.0 * kC3_0) * (xx - yy);
    by[10] = f(kC3_1) * xz;
    by[11] = f(kC3_2) * (zz * 4.0f - xx - yy * 3.0f);
    by[12] = f(-6.0 * kC3_3) * yz;
    by[13] = f(-2.0 * kC3_4) * xy;
    by[14] = f(-2.0 * kC3_5) * yz;
    by[15] = f(-6.0 * kC3_6) * xy;
    bz[10] = f(kC3_1) * xy;
    bz[11] = f(8.0 * kC3_2) * yz;
    bz[12] = f(kC3_3) * (zz * 6.0f - xx * 3.0f - yy * 3.0f);
    bz[13] = f(8.0 * kC3_4) * xz;
    bz[14] = f(kC3_5) * (xx - yy);
  }
  const int used = (in.deg + 1) * (in.deg + 1);
  float* gsh = sh;
  float g_raw[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    g_raw[ch] = eval_sh(in.deg, sh + ch, dir) + 0.5f >= 0.0f
                    ? drgb[3 * g + ch] : 0.0f;
  float g_dir[3] = {0.0f, 0.0f, 0.0f};
  bool first[3] = {true, true, true};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= used) break;
    const float s0 = sh[3 * k], s1 = sh[3 * k + 1], s2 = sh[3 * k + 2];
    gsh[3 * k] = g_raw[0] * b[k];
    gsh[3 * k + 1] = g_raw[1] * b[k];
    gsh[3 * k + 2] = g_raw[2] * b[k];
    const float dot = g_raw[0] * s0 + g_raw[1] * s1 + g_raw[2] * s2;
    const float dk[3] = {bx[k], by[k], bz[k]};
    const bool has[3] = {
        k == 3 || k == 4 || (k >= 6 && k <= 15),
        k == 1 || k == 4 || k == 5 || k == 6 || (k >= 8 && k <= 15),
        k == 2 || k == 5 || k == 6 || k == 7 || (k >= 10 && k <= 14)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (!has[j]) continue;
      g_dir[j] = first[j] ? dot * dk[j] : g_dir[j] + dot * dk[j];
      first[j] = false;
    }
  }
  for (int i = 3 * used; i < 3 * in.K; ++i) gsh[i] = 0.0f;
  if (in.deg > 0) {
    const float nn = n * n;
    const float g_n = -g_dir[0] * d[0] / nn + -g_dir[1] * d[1] / nn +
                      -g_dir[2] * d[2] / nn;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g_m[j] = g_m[j] + __fdiv_rn(g_dir[j], n) + d[j] * __fdiv_rn(g_n, n);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) g_means3d[3 * g + j] = g_m[j];
}

__global__ void __launch_bounds__(kThreads) preprocess_backward_kernel(
    const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations, const float* __restrict__ shs,
    const float* __restrict__ wv, const float* __restrict__ fp,
    const float* __restrict__ cc, const float* __restrict__ tx,
    const float* __restrict__ ty, const float* __restrict__ dmeans2d,
    const float* __restrict__ dconic, const float* __restrict__ drgb,
    Inputs in, float* __restrict__ g_means3d, float* __restrict__ g_scales,
    float* __restrict__ g_rotations, float* __restrict__ g_shs) {
  extern __shared__ float s_sh[];
  const int row = 3 * in.K;
  load_rows(s_sh, shs, row, in.n);
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < in.n)
    backward_one(g, s_sh + threadIdx.x * (row | 1), means3d, scales,
                 rotations, wv, fp, cc, tx, ty, dmeans2d, dconic, drgb, in,
                 g_means3d, g_scales, g_rotations);
  __syncthreads();
  store_rows(g_shs, s_sh, row, in.n);
}

// Dynamic shared memory of a block for K coefficients a gaussian, and the
// kernel's limit raised to it where it passes the default 48 KB.
size_t staged_bytes(const void* kernel, int K, cudaError_t* err) {
  const size_t bytes = (size_t)kThreads * ((3 * K) | 1) * sizeof(float);
  *err = bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
  return bytes;
}

}  // namespace

// The outputs means2d, rect and g_rotations are stored as 8- and 16-byte
// vectors: fresh PyTorch allocations (the wrappers make them).
extern "C" int gs_preprocess_forward(
    const void* means3d, const void* scales, const void* rotations,
    const void* opacities, const void* shs, const void* world_view,
    const void* full_proj, const void* cam_center, const void* tan_fovx,
    const void* tan_fovy, int n, int K, int deg, int width, int height,
    int tile, int gx, int gy, float scale_modifier, float near,
    float fov_clamp, float dilation, void* means2d, void* depths,
    void* conic, void* rgb, void* radius, void* rect, void* tiles_touched,
    void* stream) {
  if (n < 1 || deg < 0 || deg > 3 || K < (deg + 1) * (deg + 1) || tile < 1)
    return (int)cudaErrorInvalidValue;
  const Inputs in{n, K, deg, width, height, scale_modifier, near, fov_clamp,
                  dilation};
  cudaError_t err;
  const size_t smem =
      staged_bytes((const void*)preprocess_forward_kernel, K, &err);
  if (err != cudaSuccess) return (int)err;
  preprocess_forward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const float*)means3d, (const float*)scales, (const float*)rotations,
      (const float*)opacities, (const float*)shs, (const float*)world_view,
      (const float*)full_proj, (const float*)cam_center,
      (const float*)tan_fovx, (const float*)tan_fovy, in, tile, gx, gy,
      (float*)means2d, (float*)depths, (float*)conic, (float*)rgb,
      (int32_t*)radius, (int32_t*)rect, (int32_t*)tiles_touched);
  return (int)cudaGetLastError();
}

extern "C" int gs_preprocess_backward(
    const void* means3d, const void* scales, const void* rotations,
    const void* shs, const void* world_view, const void* full_proj,
    const void* cam_center, const void* tan_fovx, const void* tan_fovy,
    const void* dmeans2d, const void* dconic, const void* drgb, int n, int K,
    int deg, int width, int height, float scale_modifier, float near,
    float fov_clamp, float dilation, void* g_means3d, void* g_scales,
    void* g_rotations, void* g_shs, void* stream) {
  if (n < 1 || deg < 0 || deg > 3 || K < (deg + 1) * (deg + 1))
    return (int)cudaErrorInvalidValue;
  const Inputs in{n, K, deg, width, height, scale_modifier, near, fov_clamp,
                  dilation};
  cudaError_t err;
  const size_t smem =
      staged_bytes((const void*)preprocess_backward_kernel, K, &err);
  if (err != cudaSuccess) return (int)err;
  preprocess_backward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const float*)means3d, (const float*)scales, (const float*)rotations,
      (const float*)shs, (const float*)world_view, (const float*)full_proj,
      (const float*)cam_center, (const float*)tan_fovx,
      (const float*)tan_fovy, (const float*)dmeans2d, (const float*)dconic,
      (const float*)drgb, in, (float*)g_means3d, (float*)g_scales,
      (float*)g_rotations, (float*)g_shs);
  return (int)cudaGetLastError();
}

// Registers, static shared memory and blocks per SM at K = 16 (SH degree
// 3's coefficients) of P1 (which = 1) or P2 (which = 2).
extern "C" int gs_preprocess_kernel_info(int which, int* out) {
  cudaFuncAttributes attr;
  const void* fn = which == 1 ? (const void*)preprocess_forward_kernel
                              : (const void*)preprocess_backward_kernel;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  const size_t smem = staged_bytes(fn, 16, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads,
                                                      smem);
  return (int)err;
}
