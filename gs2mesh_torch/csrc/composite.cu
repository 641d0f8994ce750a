// Kernels K2 (tile compositing, forward) and K3 (its backward).
//
// ---- K2 ----
//
// Replaces gs2mesh_tpu/ops/rasterizer/pallas_kernels.py::_forward_kernel
// (launched by _fwd_call). The TPU kernel streams a tile's depth-sorted pair
// chunks through VMEM and composites a whole 128-pair chunk at once with
// prefix-product scans and an MXU matmul. Here each pixel composites
// sequentially, in the reference's (forward.cu renderCUDA) order:
//   skip a pair if alpha_raw < 1/255; alpha = min(0.99, alpha_raw);
//   stop BEFORE the first pair whose T * (1 - alpha) < 1e-4.
//
// Bound: operations. At the 300k-gaussian, 960x576 scene there are far more
// (pair, pixel) evaluations than bytes to move (the feature gather is 36
// bytes per pair), and most of them cannot land: a splat reaches the 1/255
// cut in a few percent of its tile's pixels while training and in under half
// of them on a dense model. What is left once those are gone sits in few
// tiles: on a dense model the tiles along a silhouette hold thousands of
// pairs that never saturate the pixels outside it, and a tile's pairs must
// be walked in order, so a launch is as long as its slowest block.
//
// Design:
//  * One 256-thread block per 16x16 QUARTER of a 32x32 tile, a thread one
//    pixel, warp w on the quarter's 8x4 sub-box w. The four blocks of a
//    tile walk the same sorted pair range on (most likely) four SMs, which
//    spreads a heavy tile's serial walk, and a quarter whose pixels are all
//    done leaves on its own. 56 registers, 4 blocks on an SM.
//  * As a batch of kBatch pairs is staged (stage_batch, shared with K3),
//    each pair gets the mask of the block's sub-boxes in which it can reach
//    the alpha cut: K1's box test with its 2% margin, so that no pixel that
//    could be accepted (or stopped at) is lost and colour and final_T keep
//    their bits. The test is asked only of the sub-boxes that still have a
//    running pixel and meet the box around the pair's reach (a few interval
//    tests), and a warp deals those candidates out one a lane: a batch of
//    small splats costs one round of box tests, not one per pair.
//  * A warp turns 32 masks at a time into its own list of pairs (one
//    ballot) and walks only those. The pixel's update is branch-free, so a
//    warp never diverges; a warp with no running pixel skips the walk.
//  * Raw rows, staged pairs and masks are double-buffered: while the block
//    walks batch b it stages batch b + 1 and batch b + 2's rows arrive by
//    cp.async (ids one batch further ahead in registers). A batch costs one
//    barrier, past which each warp's "still running" flag tells the block
//    which sub-boxes the next staging may skip and when to leave.
//
// Strided slices (K2 and K3 alike): with (row_offset, row_stride) the image
// is one rank's share under round-robin tile-row ownership, local tile row l
// being global row row_offset + l * row_stride. The tile origin, and so the
// tile-local means and every pixel centre, take the global y; the image
// written (or read) stays the slice's. (0, 1) is the whole image.
//
// Numerics: alpha must decide `alpha_raw >= 1/255` exactly as the reference
// does, so the tile-local mean (mx - 32*tx), dx/dy and the power
// (-0.5*ca)*(dx*dx) + dy*((-0.5*cc)*dy - cb*dx) are separately rounded
// __f*_rn ops in the reference's order (the build also passes -fmad=false),
// expf is the full-precision one, and a pixel adds its accepted pairs in
// depth order.
//
// What still holds it back: the silhouette quarters of a dense model, whose
// running sub-boxes each visit every pair (about 55 instructions a visit on
// one warp); every quarter stages its tile's whole pair range, so staging
// is done four times over; the launch order of the blocks ignores their
// weight. Tried and dropped: a floor on `power` under which the expf is
// skipped (a warp pays the exp if one lane needs it, and the vote cost more
// than it saved), whole-tile blocks with four pixels a thread as in K3 (a
// warp then executes four sub-boxes' work whether they run or not), two pairs
// a step, sub-boxes dealt to warps from all over the tile.

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
//  * One 256-thread block per 32x32 tile (79 registers, 23 KB of shared
//    memory: 3 blocks on an SM). The tile is cut into 32 sub-boxes of 8x4
//    pixels; warp w owns the four of one 16x8 region and each lane one pixel
//    in each of the four, so a thread carries 4 pixels.
//  * As a batch of kBatch pairs is staged (stage_batch, shared with K2),
//    K1's box test (cull.cuh) gives each pair its 32-bit mask of the
//    sub-boxes in which it can reach the alpha cut, asked only of the
//    sub-boxes that still have a running pixel and meet the box around the
//    pair's reach. The test keeps K1's 2% margin, so no pixel that K2
//    accepted (or stopped at) is lost.
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
constexpr int kCols = 9;
constexpr unsigned kFull = 0xffffffffu;

// A block, in K2 and K3 alike, has 8 warps and works on 8x4-pixel
// sub-boxes, lane l on the pixel (l % 8, l / 8) of a sub-box. K3's block
// owns a whole tile: each warp the four sub-boxes of a 16x8 region, a thread
// carrying one pixel of each. K2's block owns a 16x16 quarter of a tile:
// each warp one sub-box, a thread one pixel.
constexpr int kSub = 4;
constexpr int kWarps = 32 / kSub;
constexpr int kThreads = 32 * kWarps;
constexpr int kQuarter = 16;       // edge of K2's quarter tile
constexpr int kFwdMinBlocks = 4;   // blocks wanted on an SM
constexpr int kBwdMinBlocks = 3;
constexpr int kBoxW = 8, kBoxH = 4;
constexpr int kBatch = 64;       // pairs staged per batch
constexpr int kMaskWords = kBatch / 32;
static_assert(kBatch * 4 == kThreads, "4 gathering threads per pair");
static_assert(kBatch % 32 == 0, "whole mask words");
static_assert(kSub == 4 && kBoxW * kBoxH == 32 && kBoxW * 4 == kTile,
              "sub-box layout");
static_assert(kQuarter * 2 == kTile &&
                  (kQuarter / kBoxW) * (kQuarter / kBoxH) == kWarps,
              "a quarter tile is one sub-box a warp");

// A batch of staged pairs.
struct Staged {
  float4 geo[kBatch];     // tile-local mean x, y; -0.5*ca; opacity
  float4 col[kBatch];     // cb; -0.5*cc; r; g
  float blue[kBatch];
  unsigned mask[kBatch];  // sub-boxes (of the block's) the pair can reach
};

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

// The sub-boxes a block owns, as stage_batch numbers them (mask bit b):
// tile-local origin of each. K3: the tile's 32.
struct TileBoxes {
  static constexpr int kCount = 32;
  __device__ __forceinline__ int x(int b) const { return sub_box_x(b); }
  __device__ __forceinline__ int y(int b) const { return sub_box_y(b); }
};
// K2: the 8 of the quarter tile at (qx, qy), two across, warp b on box b.
struct QuarterBoxes {
  static constexpr int kCount = kWarps;
  int qx, qy;
  __device__ __forceinline__ int x(int b) const { return qx + (b & 1) * kBoxW; }
  __device__ __forceinline__ int y(int b) const { return qy + (b >> 1) * kBoxH; }
};

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Thread j of the block's 256 starts the copy of floats {j & 3, (j & 3) + 4,
// 8 if j & 3 == 0} of gaussian id's feat9 row into row j / 4 of raw (a
// batch's gathered rows); nothing for id < 0.
__device__ __forceinline__ void gather_row(const float* __restrict__ feat9,
                                           int id, float* raw, int j) {
  if (id < 0) return;
  const int gpart = j & 3;
  const float* src = feat9 + (int64_t)id * kCols;
  float* dst = raw + (j >> 2) * kCols;
  cp_async_f32(dst + gpart, src + gpart);
  cp_async_f32(dst + gpart + 4, src + gpart + 4);
  if (gpart == 0) cp_async_f32(dst + 8, src + 8);
}

// Half-extents (pixels, about the mean) of the axis-aligned box around the
// ellipse inside which a gaussian can reach the alpha cut less cull.cuh's 2%
// margin: q <= L = log(op / kAliveMin) bounds dx^2 by 2 L cc / det and dy^2
// by 2 L ca / det. Widened by 1% and half a pixel, far more than the float
// error of the box test it screens for; +inf for a conic that is not
// positive definite; -inf (no box meets it) where op is under the cut.
__device__ __forceinline__ void reach_extents(float ca, float cb, float cc,
                                              float op, float* hx, float* hy) {
  const float L = logf(op / gs_cull::kAliveMin) + 1e-3f;
  const float k = 2.0f * L / (ca * cc - cb * cb);
  const float ex = k * cc, ey = k * ca;
  const float inf = __int_as_float(0x7f800000);
  *hx = L < 0.0f ? -inf : ex >= 0.0f ? 1.01f * sqrtf(ex) + 0.5f : inf;
  *hy = L < 0.0f ? -inf : ey >= 0.0f ? 1.01f * sqrtf(ey) + 0.5f : inf;
}

// Stages the n gathered rows (GLOBAL means) of a batch for the tile with
// origin (ox, oy) and the block's sub-boxes `boxes`; warp w takes pairs
// 8w .. 8w + 7, four lanes a pair. A pair's mask is K1's box test (cull.cuh,
// with its 2% margin) on each sub-box, but only where it can matter: on the
// sub-boxes in `live` (those that still have a running pixel) that meet the
// pair's reach_extents box, a few cheap interval tests a lane. The warp then
// deals its pairs' candidate sub-boxes out 32 at a time, one box test a
// lane, so a batch of small splats costs a warp one round of box tests or
// two.
template <class Boxes>
__device__ __forceinline__ void stage_batch(const float* raw, int n, float ox,
                                            float oy, unsigned live,
                                            const Boxes boxes, int warp,
                                            int lane, Staged* st) {
  constexpr int kPairs = kBatch / kWarps;      // pairs a warp stages
  constexpr int kPerLane = Boxes::kCount / 4;  // interval tests a lane
  static_assert(kPairs * 4 == 32, "four lanes a pair");
  const int part = lane & 3;
  const int k = warp * kPairs + (lane >> 2);
  const float* f = raw + k * kCols;
  float mx = 0.0f, my = 0.0f;
  unsigned cand = 0;
  if (k < n) {
    mx = __fsub_rn(f[0], ox);
    my = __fsub_rn(f[1], oy);
    float hx, hy;
    reach_extents(f[2], f[3], f[4], f[5], &hx, &hy);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int b = part * kPerLane + i;
      const float x_lo = (float)boxes.x(b) - mx;
      const float y_lo = (float)boxes.y(b) - my;
      if (x_lo <= hx && x_lo + (float)(kBoxW - 1) >= -hx && y_lo <= hy &&
          y_lo + (float)(kBoxH - 1) >= -hy)
        cand |= 1u << b;
    }
  }
  cand |= __shfl_xor_sync(kFull, cand, 1);
  cand |= __shfl_xor_sync(kFull, cand, 2);
  cand &= live;
  if (part == 0 && k < n) {
    st->geo[k] = make_float4(mx, my, -0.5f * f[2], f[5]);
    st->col[k] = make_float4(f[3], -0.5f * f[4], f[6], f[7]);
    st->blue[k] = f[8];
    st->mask[k] = 0;
  }
  __syncwarp();

  // start[p]: candidates of the warp's pairs before pair p.
  const int count = __popc(cand);
  int start[kPairs + 1];
  start[0] = 0;
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
    start[p + 1] = start[p] + __shfl_sync(kFull, count, 4 * p);
  for (int base = 0; base < start[kPairs]; base += 32) {
    const int idx = base + lane;
    int p = 0, first = 0;        // the pair that holds candidate idx
#pragma unroll
    for (int t = 1; t < kPairs; ++t)
      if (idx >= start[t]) {
        p = t;
        first = start[t];
      }
    const unsigned of_pair = __shfl_sync(kFull, cand, 4 * p);
    if (idx >= start[kPairs]) continue;
    const int b = __fns(of_pair, 0, idx - first + 1);
    const int kp = warp * kPairs + p;
    const float* g = raw + kp * kCols;
    const float x_lo = __fsub_rn((float)boxes.x(b), __fsub_rn(g[0], ox));
    const float y_lo = __fsub_rn((float)boxes.y(b), __fsub_rn(g[1], oy));
    if (gs_cull::box_alive(g[2], g[3], g[4], g[5], x_lo,
                           __fadd_rn(x_lo, (float)(kBoxW - 1)), y_lo,
                           __fadd_rn(y_lo, (float)(kBoxH - 1))))
      atomicOr(&st->mask[kp], 1u << b);
  }
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

// Bit q: sub-box q of this warp still has a running pixel (K3; bit q of
// `done` says the thread's pixel q has stopped).
__device__ __forceinline__ unsigned running_boxes(unsigned done) {
  unsigned running = 0;
#pragma unroll
  for (int q = 0; q < kSub; ++q)
    if (__ballot_sync(kFull, !(done >> q & 1))) running |= 1u << q;
  return running;
}

__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
composite_forward_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ feat9,
    int width, int height, int gx, int row_offset, int row_stride,
    float alpha_min, float alpha_clamp, float t_eps, float* __restrict__ color,
    float* __restrict__ final_T) {
  __shared__ float s_raw[2][kBatch * kCols];   // gathered feat9 rows
  __shared__ Staged s_st[2];
  __shared__ unsigned s_run[2][kWarps];        // has the warp a running pixel

  const int t = blockIdx.x >> 2, quarter = blockIdx.x & 3;
  const int start = starts[t], count = counts[t];
  const int tx = t % gx, ty = t / gx;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const float ox = (float)(tx * kTile);
  const float oy = (float)((row_offset + ty * row_stride) * kTile);
  const QuarterBoxes boxes{(quarter & 1) * kQuarter, (quarter >> 1) * kQuarter};

  // This thread's pixel: lane's place in the warp's sub-box.
  const int lx = boxes.x(warp) + (lane & (kBoxW - 1));
  const int ly = boxes.y(warp) + lane / kBoxW;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool in_image = x < width && y < height;
  const float px = (float)lx, py = (float)ly;
  float T = 1.0f, c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  bool done = !in_image;
  bool running = __any_sync(kFull, !done);     // of the warp's pixels

  if (count > 0) {
    // The block's sub-boxes that still have a running pixel, from the flags
    // the warps left in s_run[buf] before the last barrier.
    auto live_boxes = [&](int buf) {
      unsigned live = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) live |= s_run[buf][w] << w;
      return live;
    };
    // id_next: the gaussian whose row this thread gathers next (-1 past the
    // tile's last pair), one batch ahead of the rows in flight.
    const int gp = j >> 2;
    auto id_at = [&](int first) {
      return first + gp < count ? ids[start + first + gp] : -1;
    };
    gather_row(feat9, id_at(0), s_raw[0], j);
    int id_next = id_at(kBatch);
    if (lane == 0) s_run[1][warp] = running;
    cp_async_wait_all();
    __syncthreads();
    gather_row(feat9, id_next, s_raw[1], j);
    id_next = id_at(2 * kBatch);
    stage_batch(s_raw[0], min(kBatch, count), ox, oy, live_boxes(1), boxes,
                warp, lane, &s_st[0]);
    if (lane == 0) s_run[0][warp] = running;

    for (int base = 0, buf = 0; base < count; base += kBatch, buf ^= 1) {
      cp_async_wait_all();
      // Past this barrier batch `base` is staged, the rows of the next one
      // have landed, and nobody reads the buffers of the one before.
      __syncthreads();
      const unsigned live = live_boxes(buf);
      if (live == 0) break;          // every pixel of the quarter is done
      const int n = min(kBatch, count - base);
      const int n_next = min(kBatch, count - base - kBatch);
      gather_row(feat9, id_next, s_raw[buf], j);
      id_next = id_at(base + 3 * kBatch);
      if (n_next > 0)
        stage_batch(s_raw[buf ^ 1], n_next, ox, oy, live, boxes, warp, lane,
                    &s_st[buf ^ 1]);

      // Walk: 32 masks at a time become this warp's list of pairs. The
      // pixel's update is branch-free (no divergence inside the warp) and
      // is the reference's separately rounded sequence.
      const Staged& st = s_st[buf];
      for (int c0 = 0; c0 < n && running; c0 += 32) {
        const int kl = c0 + lane;
        unsigned todo =
            __ballot_sync(kFull, kl < n && (st.mask[kl] >> warp & 1));
        while (todo) {
          const int k = c0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const float4 a = st.geo[k];
          const float4 b = st.col[k];
          const float blue = st.blue[k];
          float dx, dy, G;
          const float alpha_raw = pair_alpha_raw(a, b, px, py, &dx, &dy, &G);
          const bool lands = !done && alpha_raw >= alpha_min;
          const float alpha = fminf(alpha_clamp, alpha_raw);
          const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
          const bool stop = lands && test_T < t_eps;
          const bool accept = lands && !stop;
          done |= stop;
          const float w = __fmul_rn(alpha, T);
          c_r = accept ? __fadd_rn(c_r, __fmul_rn(b.z, w)) : c_r;
          c_g = accept ? __fadd_rn(c_g, __fmul_rn(b.w, w)) : c_g;
          c_b = accept ? __fadd_rn(c_b, __fmul_rn(blue, w)) : c_b;
          T = accept ? test_T : T;
        }
        running = __any_sync(kFull, !done);
      }
      if (lane == 0) s_run[buf ^ 1][warp] = running;
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

__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
composite_backward_kernel(
    const int32_t* __restrict__ ids, const int64_t* __restrict__ order,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
    const float* __restrict__ feat9, const float* __restrict__ color,
    const float* __restrict__ final_T, const float* __restrict__ dcolor,
    const float* __restrict__ dfinal_T, int width, int height, int gx,
    int row_offset, int row_stride, float alpha_min, float alpha_clamp,
    float t_eps, float* __restrict__ dpairs) {
  __shared__ float s_raw[kBatch * kCols];      // gathered feat9 rows
  __shared__ Staged s_st;
  __shared__ unsigned s_acc[kWarps][kMaskWords];  // pairs a warp accepted
  __shared__ unsigned s_run[kWarps];           // each warp's running_boxes
  __shared__ float s_part[kWarps * kBatch * kCols];   // [warp][pair][col]

  const int t = blockIdx.x;
  const int start = starts[t], count = counts[t];
  if (count <= 0) return;
  const int tx = t % gx, ty = t / gx;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const float ox = (float)(tx * kTile);
  const float oy = (float)((row_offset + ty * row_stride) * kTile);

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

  // Gather (gather_row): id_next is the gaussian of pair j / 4 in the batch
  // after the one being staged (-1 past the tile's last pair).
  const int gp = j >> 2;
  int id_next = gp < count ? ids[start + gp] : -1;
  gather_row(feat9, id_next, s_raw, j);
  id_next = kBatch + gp < count ? ids[start + kBatch + gp] : -1;
  cp_async_wait_all();
  __syncthreads();

  unsigned live = kFull;   // sub-boxes of the tile with a running pixel
  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);

    stage_batch(s_raw, n, ox, oy, live, TileBoxes{}, warp, lane, &s_st);
    __syncthreads();

    // The raw rows are consumed: the next batch's land during the walk.
    gather_row(feat9, id_next, s_raw, j);
    id_next = base + 2 * kBatch + gp < count
                  ? ids[start + base + 2 * kBatch + gp] : -1;

    // Walk: 32 masks at a time become this warp's list of pairs.
    for (int c0 = 0; c0 < n; c0 += 32) {
      const unsigned running = running_boxes(done);
      const int kl = c0 + lane;
      const unsigned mine =
          kl < n ? (s_st.mask[kl] >> (warp * kSub)) & running : 0u;
      unsigned todo = __ballot_sync(kFull, mine != 0);
      unsigned accepted_pairs = 0;
      while (todo) {
        const int kk = __ffs(todo) - 1;
        todo &= todo - 1;
        const unsigned boxes = __shfl_sync(kFull, mine, kk);
        const int k = c0 + kk;
        const float4 a = s_st.geo[k];
        const float4 b = s_st.col[k];
        const float blue = s_st.blue[k];
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

    const unsigned running = running_boxes(done);
    if (lane == 0) s_run[warp] = running;
    cp_async_wait_all();
    // The partials, the next batch's rows and every warp's running boxes
    // are visible past this barrier (s_run is written again only past the
    // next batch's staging barrier).
    __syncthreads();
    live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) live |= s_run[w] << (w * kSub);

    // Cross-warp sum, ascending warp order, of the warps that accepted.
    for (int i = j; i < n * kCols; i += kThreads) {
      const int k = i / kCols;
      unsigned warps = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
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
    if (live == 0) break;          // every pixel of the tile is done
  }
}

}  // namespace

extern "C" int gs_composite_forward(const void* ids, const void* starts,
                                    const void* counts, const void* feat9,
                                    int width, int height, int gx, int gy,
                                    int row_offset, int row_stride,
                                    float alpha_min, float alpha_clamp,
                                    float t_eps, void* color, void* final_T,
                                    void* stream) {
  composite_forward_kernel<<<4 * gx * gy, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)starts, (const int32_t*)counts,
      (const float*)feat9, width, height, gx, row_offset, row_stride,
      alpha_min, alpha_clamp, t_eps, (float*)color, (float*)final_T);
  return (int)cudaGetLastError();
}

// dpairs must be 16-byte aligned (the wrapper allocates it). Rows at or past
// min(*num_pairs, capacity) are left unwritten.
extern "C" int gs_composite_backward(
    const void* ids, const void* order, const void* starts,
    const void* counts, const void* num_pairs, const void* feat9,
    const void* color, const void* final_T, const void* dcolor,
    const void* dfinal_T, int width, int height, int gx, int gy,
    int row_offset, int row_stride, long long capacity, float alpha_min,
    float alpha_clamp, float t_eps, void* dpairs, void* stream) {
  composite_backward_fill_kernel<<<528, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)num_pairs, (int64_t)capacity, (float*)dpairs);
  composite_backward_kernel<<<gx * gy, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int64_t*)order, (const int32_t*)starts,
      (const int32_t*)counts, (const float*)feat9, (const float*)color,
      (const float*)final_T, (const float*)dcolor, (const float*)dfinal_T,
      width, height, gx, row_offset, row_stride, alpha_min, alpha_clamp,
      t_eps, (float*)dpairs);
  return (int)cudaGetLastError();
}

// out[0..2] = registers per thread, static shared memory bytes and the
// blocks the occupancy API fits on one SM, of K2 (which = 2) or K3 (3).
// Returns the CUDA error.
extern "C" int gs_composite_kernel_info(int which, int* out) {
  const void* fn = which == 2 ? (const void*)composite_forward_kernel
                              : (const void*)composite_backward_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  err = which == 2
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &out[2], composite_forward_kernel, kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &out[2], composite_backward_kernel, kThreads, 0);
  return (int)err;
}
