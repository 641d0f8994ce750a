// The alpha-cut box test shared by K1 (emit.cu: a pair's whole tile) and by
// K2 and K3 (composite.cu: each 8x4 sub-box of the tile): can a gaussian
// reach the compositors' 1/255 alpha cut anywhere in a box of pixel centres?
//
// The box is [x_lo, x_hi] x [y_lo, y_hi] in pixel-minus-mean coordinates.
// The conic quadratic q = 0.5*(ca*dx^2 + cc*dy^2) + cb*dx*dy is convex, so
// its minimum over the box is 0 if the mean lies inside and otherwise lies
// on one of the four edges, at the clamped 1-D minimiser of that edge. The
// pair is alive if op * exp(-qmin) >= 0.98/255: the 2% margin absorbs any
// float disagreement with the compositors' own per-pixel alpha.
//
// Numerics: K1's keys must equal the reference's bit for bit, so every float
// op is a separately rounded __f*_rn intrinsic in the reference's operation
// order (the build also passes -fmad=false) and expf is the full-precision
// one.

#pragma once

#include <cuda_runtime.h>

namespace gs_cull {

// 0.98 / 255 rounded once from double to float, as the reference does.
constexpr float kAliveMin = (float)(0.98 / 255.0);

// 0.5 * (ca*dx*dx + cc*dy*dy) + cb*dx*dy
__device__ __forceinline__ float qval(float ca, float cb, float cc, float dx,
                                      float dy) {
  const float a = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float c = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float b = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(a, c)), b);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Minimum of the conic quadratic over dy in [y_lo, y_hi] at fixed dx.
__device__ __forceinline__ float edge_x(float ca, float cb, float cc, float dx,
                                        float y_lo, float y_hi) {
  const float dy =
      clip(__fdiv_rn(__fmul_rn(-cb, dx), fmaxf(cc, 1e-12f)), y_lo, y_hi);
  return qval(ca, cb, cc, dx, dy);
}

__device__ __forceinline__ float edge_y(float ca, float cb, float cc, float dy,
                                        float x_lo, float x_hi) {
  const float dx =
      clip(__fdiv_rn(__fmul_rn(-cb, dy), fmaxf(ca, 1e-12f)), x_lo, x_hi);
  return qval(ca, cb, cc, dx, dy);
}

__device__ __forceinline__ bool box_alive(float ca, float cb, float cc,
                                          float op, float x_lo, float x_hi,
                                          float y_lo, float y_hi) {
  const bool inside =
      (x_lo <= 0.0f) && (0.0f <= x_hi) && (y_lo <= 0.0f) && (0.0f <= y_hi);
  float qmin = 0.0f;
  if (!inside) {
    qmin = fminf(fminf(edge_x(ca, cb, cc, x_lo, y_lo, y_hi),
                       edge_x(ca, cb, cc, x_hi, y_lo, y_hi)),
                 fminf(edge_y(ca, cb, cc, y_lo, x_lo, x_hi),
                       edge_y(ca, cb, cc, y_hi, x_lo, x_hi)));
  }
  return __fmul_rn(op, expf(-qmin)) >= kAliveMin;
}

}  // namespace gs_cull
