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
// What it computes: the forward-order replay of K2 over a tile's sorted
// pairs, the alpha / 1/255 skip / T-stop decisions made by the same
// __device__ code as K2 (so they match the forward bit for bit). Per
// accepted pair and pixel, with U_tot = sum_c color_c*dC_c + dTf*T_final and
// U_run the inclusive prefix of u*w (u = rgb . dC):
//   dalpha = u*T - (U_tot - U_run) / (1 - alpha),  dpower = dalpha*alpha_raw
// (no gate on the 0.99 clamp, as in the reference backward), then the 9
// gradients [d mean x, y, conic a, b, c, opacity, r, g, b], summed over the
// tile's pixels into the pair's row.
//
// Bound: operations, and on this card not the arithmetic of the accepted
// evaluations but everything around them. A splat covers a few percent of
// its tile's pixels while training (a third of them on a dense model), so a
// kernel that lets every pixel evaluate every pair and reduces every pair
// over every warp spends its time on evaluations that cannot land, on
// shuffles and shared-memory sums of zeros, and at barriers. What is left
// once those are gone is latency: a warp's visit to a pair is one dependent
// chain (alpha, the T test, the gradient, the reduction) and a tile's pairs
// must be visited in order, so the kernel takes as long as its heaviest
// tile's busiest warp.
//
// Design:
//  * One 256-thread block per 32x32 tile (78 registers, 23 KB of shared
//    memory: 3 blocks on an SM). The tile is cut into 32 sub-boxes of 8x4
//    pixels; warp w owns the four of one 16x8 region and each lane one pixel
//    in each of the four, so a thread carries 4 pixels.
//  * As a batch of kBatch pairs is staged, lane b of the staging warp runs
//    K1's box test (cull.cuh) for sub-box b and one __ballot_sync makes the
//    pair's 32-bit mask of the sub-boxes in which it can reach the alpha
//    cut. The test keeps K1's 2% margin, so no pixel that K2 accepted (or
//    stopped at) is lost.
//  * A warp turns 32 masks at a time into its own list of pairs (one
//    ballot) and walks only those, and of a pair only the sub-boxes whose
//    bit is set and in which a pixel is still running. A (pair, warp) that
//    cannot land costs nothing.
//  * The accept / skip / stop decisions are K2's, op for op; the gradient
//    terms behind them are free to fuse (explicit fmaf, a fast division by
//    1 - alpha, which lies in [0.01, 1]).
//  * A thread sums its (up to) 4 pixels in registers; a warp that accepted
//    reduces the 9 sums over its lanes with 14 shuffles (a butterfly that
//    halves the values a lane carries at each of the first three steps)
//    and writes one partial row; each warp keeps one bit per pair saying
//    whether it did. The cross-warp sum adds the partials of the warps
//    whose bit is set, in ascending warp order, neighbouring threads on
//    neighbouring floats of a [warp][pair][col] layout, and writes the row
//    at the pair's emission slot. No float atomics anywhere: the same
//    inputs give the same bits on every run. A pair that no warp accepted
//    is not written at all.
//  * The next batch's feature rows are gathered by cp.async (ids one batch
//    further ahead in registers) while the current batch is walked; a
//    batch costs two barriers.
//  * The rows K3 does not write must read as zero to K4: a fill kernel
//    launched just before K3 zeroes the slots below num_pairs (read on the
//    device); the slots above are never read and stay unwritten.
//
// What still holds it back: the two barriers of a batch keep the warps in
// step, and depth order sweeps across a tile (a surface's near side comes
// first), so in any one batch the pairs crowd into a few warps' regions and
// the others wait. Dealing a warp sub-boxes from all over the tile evens
// that out but makes every small splat meet several warps; that, 2 sub-boxes
// a warp (512 threads), batches of 128, walking two pairs at a time with a
// joint 21-shuffle butterfly, and launching the tiles heaviest first were
// each tried and were no better in both regimes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;
constexpr int kCols = 9;
constexpr unsigned kFull = 0xffffffffu;

// K3's block: 8 warps, each on the four 8x4 sub-boxes of a 16x8 region, a
// thread carrying one pixel of each.
constexpr int kSub = 4;
constexpr int kBwdWarps = 32 / kSub;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMinBlocks = 3;   // blocks wanted on an SM
constexpr int kBoxW = 8, kBoxH = 4;
constexpr int kBatch = 64;       // pairs staged per batch
constexpr int kMaskWords = kBatch / 32;
static_assert(kBatch * 4 == kBwdThreads, "4 gathering threads per pair");
static_assert(kBatch % 32 == 0, "whole mask words");
static_assert(kSub == 4 && kBoxW * kBoxH == 32 && kBoxW * 4 == kTile,
              "sub-box layout");

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

// Tile-local origin of the sub-box with mask bit b = warp * kSub + q: warp
// w owns the 16x8 region at ((w & 1) * 16, (w / 2) * 8), whose sub-box q lies
// at ((q & 1) * 8, (q / 2) * 4) inside it. A warp's sub-boxes are neighbours,
// so that a small splat meets one warp or two.
__device__ __forceinline__ int sub_box_pos(int b) {   // row-major, 4 across
  const int w = b / kSub, q = b % kSub;
  return ((w >> 1) * 2 + (q >> 1)) * 4 + (w & 1) * 2 + (q & 1);
}
__device__ __forceinline__ int sub_box_x(int b) {
  return (sub_box_pos(b) & 3) * kBoxW;
}
__device__ __forceinline__ int sub_box_y(int b) {
  return (sub_box_pos(b) >> 2) * kBoxH;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Zeroes the rows [0, min(*num_pairs, capacity)) of dpairs (16-byte aligned).
__global__ void __launch_bounds__(256) composite_backward_fill_kernel(
    const int64_t* __restrict__ num_pairs_p, int64_t capacity,
    float* __restrict__ dpairs) {
  const int64_t rows = min(*num_pairs_p, capacity);
  const int64_t n_float = rows * kCols, n_vec = n_float >> 2;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float4* v = reinterpret_cast<float4*>(dpairs);
  for (int64_t i = tid; i < n_vec; i += stride)
    v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < (n_float & 3)) dpairs[(n_vec << 2) + tid] = 0.0f;
}

__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
composite_backward_kernel(
    const int32_t* __restrict__ ids, const int64_t* __restrict__ order,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
    const float* __restrict__ feat9, const float* __restrict__ color,
    const float* __restrict__ final_T, const float* __restrict__ dcolor,
    const float* __restrict__ dfinal_T, int width, int height, int gx,
    float alpha_min, float alpha_clamp, float t_eps,
    float* __restrict__ dpairs) {
  __shared__ float s_raw[kBatch * kCols];      // gathered feat9 rows
  __shared__ float4 s_geo[kBatch];
  __shared__ float4 s_col[kBatch];
  __shared__ float s_blue[kBatch];
  __shared__ unsigned s_mask[kBatch];          // sub-boxes a pair can reach
  __shared__ unsigned s_acc[kBwdWarps][kMaskWords];  // pairs a warp accepted
  __shared__ float s_part[kBwdWarps * kBatch * kCols];   // [warp][pair][col]

  const int t = blockIdx.x;
  const int start = starts[t], count = counts[t];
  if (count <= 0) return;
  const int tx = t % gx, ty = t / gx;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const float ox = (float)(tx * kTile), oy = (float)(ty * kTile);

  // This thread's pixel in each of its warp's four sub-boxes.
  float dCr[kSub], dCg[kSub], dCb[kSub], U_tot[kSub], T[kSub], U_run[kSub];
  float px[kSub], py[kSub];
  unsigned done = 0;               // bit q: pixel q has stopped
#pragma unroll
  for (int q = 0; q < kSub; ++q) {
    const int lx = sub_box_x(warp * kSub + q) + (lane & (kBoxW - 1));
    const int ly = sub_box_y(warp * kSub + q) + lane / kBoxW;
    px[q] = (float)lx;
    py[q] = (float)ly;
    const int x = tx * kTile + lx;
    const int y = ty * kTile + ly;
    dCr[q] = dCg[q] = dCb[q] = U_tot[q] = U_run[q] = 0.0f;
    T[q] = 1.0f;
    if (x < width && y < height) {
      const int64_t hw = (int64_t)width * height;
      const int64_t p = (int64_t)y * width + x;
      dCr[q] = dcolor[p];
      dCg[q] = dcolor[hw + p];
      dCb[q] = dcolor[2 * hw + p];
      U_tot[q] = color[p] * dCr[q] + color[hw + p] * dCg[q] +
                 color[2 * hw + p] * dCb[q] + dfinal_T[p] * final_T[p];
    } else {
      done |= 1u << q;
    }
  }

  // Gather: thread j copies floats {j & 3, (j & 3) + 4, 8 if j & 3 == 0} of
  // pair j / 4 of a batch. id_next is that pair's gaussian in the batch
  // after the one being staged (-1 past the tile's last pair).
  const int gp = j >> 2, gpart = j & 3;
  int id_next = gp < count ? ids[start + gp] : -1;
  auto gather = [&]() {
    if (id_next < 0) return;
    const float* src = feat9 + (int64_t)id_next * kCols;
    float* dst = s_raw + gp * kCols;
    cp_async_f32(dst + gpart, src + gpart);
    cp_async_f32(dst + gpart + 4, src + gpart + 4);
    if (gpart == 0) cp_async_f32(dst + 8, src + 8);
  };
  gather();
  id_next = kBatch + gp < count ? ids[start + kBatch + gp] : -1;
  cp_async_wait_all();
  __syncthreads();

  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);

    // Stage this warp's share of the batch; lane b tests sub-box b.
    for (int k = warp; k < n; k += kBwdWarps) {
      const float* f = s_raw + k * kCols;
      float4 geo, col;
      float blue;
      stage_pair(f, ox, oy, &geo, &col, &blue);
      const float x_lo = __fsub_rn((float)sub_box_x(lane), geo.x);
      const float y_lo = __fsub_rn((float)sub_box_y(lane), geo.y);
      const unsigned m = __ballot_sync(
          kFull, gs_cull::box_alive(f[2], f[3], f[4], f[5], x_lo,
                                    __fadd_rn(x_lo, (float)(kBoxW - 1)), y_lo,
                                    __fadd_rn(y_lo, (float)(kBoxH - 1))));
      if (lane == 0) {
        s_geo[k] = geo;
        s_col[k] = col;
        s_blue[k] = blue;
        s_mask[k] = m;
      }
    }
    __syncthreads();

    // The raw rows are consumed: the next batch's land during the walk.
    gather();
    id_next = base + 2 * kBatch + gp < count
                  ? ids[start + base + 2 * kBatch + gp] : -1;

    // Walk: 32 masks at a time become this warp's list of pairs.
    for (int c0 = 0; c0 < n; c0 += 32) {
      unsigned running = 0;        // sub-boxes with a pixel still running
#pragma unroll
      for (int q = 0; q < kSub; ++q)
        if (__ballot_sync(kFull, !(done >> q & 1))) running |= 1u << q;
      const int kl = c0 + lane;
      const unsigned mine =
          kl < n ? (s_mask[kl] >> (warp * kSub)) & running : 0u;
      unsigned todo = __ballot_sync(kFull, mine != 0);
      unsigned accepted_pairs = 0;
      while (todo) {
        const int kk = __ffs(todo) - 1;
        todo &= todo - 1;
        const unsigned boxes = __shfl_sync(kFull, mine, kk);
        const int k = c0 + kk;
        const float4 a = s_geo[k];
        const float4 b = s_col[k];
        const float blue = s_blue[k];
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = 0.0f;
        bool active = false;
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (!(boxes >> q & 1) || (done >> q & 1)) continue;
          float dx, dy, G;
          const float alpha_raw =
              pair_alpha_raw(a, b, px[q], py[q], &dx, &dy, &G);
          if (!(alpha_raw >= alpha_min)) continue;
          const float alpha = fminf(alpha_clamp, alpha_raw);
          const float one_m = __fsub_rn(1.0f, alpha);
          const float test_T = __fmul_rn(T[q], one_m);
          if (test_T < t_eps) {
            done |= 1u << q;
            continue;
          }
          active = true;
          // The decisions above are K2's, op for op. The gradient below is
          // free to fuse: explicit fmaf, and a fast division by 1 - alpha,
          // which lies in [0.01, 1].
          const float w = alpha * T[q];
          const float u = fmaf(b.z, dCr[q], fmaf(b.w, dCg[q], blue * dCb[q]));
          U_run[q] = fmaf(u, w, U_run[q]);
          const float dalpha =
              fmaf(u, T[q], -__fdividef(U_tot[q] - U_run[q], one_m));
          const float dpower = dalpha * alpha_raw;
          const float bx = b.x * dx, by = b.x * dy;
          v[0] = fmaf(dpower, fmaf(2.0f * a.z, dx, -by), v[0]);
          v[1] = fmaf(dpower, fmaf(2.0f * b.y, dy, -bx), v[1]);
          const float hp = -0.5f * dpower;
          v[2] = fmaf(hp, dx * dx, v[2]);
          v[3] = fmaf(-dpower, dx * dy, v[3]);
          v[4] = fmaf(hp, dy * dy, v[4]);
          v[5] = fmaf(dalpha, G, v[5]);
          v[6] = fmaf(w, dCr[q], v[6]);
          v[7] = fmaf(w, dCg[q], v[7]);
          v[8] = fmaf(w, dCb[q], v[8]);
          T[q] = test_T;
        }
        if (!__any_sync(kFull, active)) continue;
        accepted_pairs |= 1u << kk;
        // Butterfly over the lanes: v[0..7] halve at each of three steps
        // (a lane keeps the half its lane bit selects), then two steps on
        // the one value left; v[8] takes the plain five steps.
        {
          const bool up = lane & 16;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float send = up ? v[i] : v[i + 4];
            const float keep = up ? v[i + 4] : v[i];
            v[i] = keep + __shfl_xor_sync(kFull, send, 16);
          }
        }
        {
          const bool up = lane & 8;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float send = up ? v[i] : v[i + 2];
            const float keep = up ? v[i + 2] : v[i];
            v[i] = keep + __shfl_xor_sync(kFull, send, 8);
          }
        }
        {
          const bool up = lane & 4;
          const float send = up ? v[0] : v[1];
          const float keep = up ? v[1] : v[0];
          v[0] = keep + __shfl_xor_sync(kFull, send, 4);
        }
        v[0] += __shfl_xor_sync(kFull, v[0], 2);
        v[0] += __shfl_xor_sync(kFull, v[0], 1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v[8] += __shfl_xor_sync(kFull, v[8], off);
        // Lanes 4c hold column c = lane / 4 (c < 8); every lane holds v[8].
        float* part = s_part + (warp * kBatch + k) * kCols;
        if ((lane & 3) == 0) part[lane >> 2] = v[0];
        if (lane == 1) part[8] = v[8];
      }
      if (lane == 0) s_acc[warp][c0 >> 5] = accepted_pairs;
    }

    cp_async_wait_all();
    // The partials and the next batch's rows are visible past this barrier.
    const bool all_done = __syncthreads_and(done == (1u << kSub) - 1);

    // Cross-warp sum, ascending warp order, of the warps that accepted.
    for (int i = j; i < n * kCols; i += kBwdThreads) {
      const int k = i / kCols;
      unsigned warps = 0;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        warps |= (s_acc[w][k >> 5] >> (k & 31) & 1u) << w;
      if (warps == 0) continue;
      float s = 0.0f;
      while (warps) {
        const int w = __ffs(warps) - 1;
        warps &= warps - 1;
        s += s_part[w * kBatch * kCols + i];
      }
      dpairs[order[start + base + k] * kCols + (i - k * kCols)] = s;
    }
    if (all_done) break;
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

// dpairs must be 16-byte aligned (the wrapper allocates it). Rows at or past
// min(*num_pairs, capacity) are left unwritten.
extern "C" int gs_composite_backward(
    const void* ids, const void* order, const void* starts,
    const void* counts, const void* num_pairs, const void* feat9,
    const void* color, const void* final_T, const void* dcolor,
    const void* dfinal_T, int width, int height, int gx, int gy,
    long long capacity, float alpha_min, float alpha_clamp, float t_eps,
    void* dpairs, void* stream) {
  composite_backward_fill_kernel<<<528, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)num_pairs, (int64_t)capacity, (float*)dpairs);
  composite_backward_kernel<<<gx * gy, kBwdThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int64_t*)order, (const int32_t*)starts,
      (const int32_t*)counts, (const float*)feat9, (const float*)color,
      (const float*)final_T, (const float*)dcolor, (const float*)dfinal_T,
      width, height, gx, alpha_min, alpha_clamp, t_eps, (float*)dpairs);
  return (int)cudaGetLastError();
}

// Blocks of K3 that the occupancy API fits on one SM (negative: the CUDA
// error, negated).
extern "C" int gs_composite_backward_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, composite_backward_kernel, kBwdThreads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}
