// Kernel K4: per-gaussian segment sum of per-pair gradients.
//
// Replaces gs2mesh_tpu/ops/rasterizer/emit.py::_segsum_kernel (launched by
// segment_sum_tpu from _reduce_sorted_cts / reduce_compact_cts). The TPU
// kernel sums gaussian-id-sorted cotangent chunks into 512-gaussian blocks
// with one-hot MXU matmuls, after a second sort of the pair gradients by
// gaussian id. None of that is needed here: kernel K3 writes each pair's
// gradient at its EMISSION slot, and emission order is gaussian-major
// (offsets is the exclusive prefix sum of counts, so gaussian g owns slots
// [offsets[g], offsets[g] + counts[g]) and the segments lie back to back),
// so each gaussian's pairs are already one contiguous segment.
//
// Bound: bytes. Every slot's 36-byte row is read once and every gaussian's
// 36-byte row written once, with one add per 4 bytes read: the kernel is as
// fast as its loads and stores are wide and coalesced. A thread that walks
// its own segment in device memory gets neither: a warp's loads stride by a
// segment and each thread stores its 36-byte row alone.
//
// Design: the block, not the thread, touches device memory. A block owns
// kGauss consecutive gaussians, whose segments form one contiguous span of
// slots. It copies the span into shared memory kChunkRows rows at a time as
// flat 16-byte vectors, neighbouring threads on neighbouring addresses
// (36-byte rows are not 16-byte aligned, so the copy starts at the aligned
// address at or below the chunk's first float). Each thread then adds the
// rows of its own gaussian that lie in the chunk, from shared memory (the
// row stride of 9 floats is odd, so threads on neighbouring rows hit
// different banks), in slot order, with accumulators that carry over from
// chunk to chunk when a span (or one gaussian's segment) is longer than a
// chunk. A gaussian with no pairs reads nothing. The block's kGauss x 9
// results go through shared memory and out as one contiguous run.
//
// Numerics: float32 __fadd_rn from 0 in slot order: deterministic (no
// atomics) and independent of the chunking, so the result equals a
// sequential float32 sum over each segment bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 9;
constexpr int kGauss = 256;        // gaussians per block, one per thread
constexpr int kChunkRows = 512;    // slot rows staged per chunk
// Staged floats: the rows plus up to 3 floats before the first (alignment)
// and the rest of the last 16-byte vector.
constexpr int kChunkFloats = kChunkRows * kCols + 8;
static_assert(kChunkFloats >= kGauss * kCols, "the output run is staged too");

__global__ void __launch_bounds__(kGauss) segment_sum_kernel(
    const float* __restrict__ dpairs, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ counts, int n, int64_t capacity,
    float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[kChunkFloats];

  const int g0 = blockIdx.x * kGauss;
  const int g_last = min(g0 + kGauss, n) - 1;
  const int g = g0 + threadIdx.x;

  // This thread's segment and the block's span, clipped to the capacity.
  int64_t s0 = 0, s1 = 0;
  if (g < n) {
    s0 = min(offsets[g], capacity);
    s1 = min(s0 + counts[g], capacity);
  }
  const int64_t span0 = min(offsets[g0], capacity);
  const int64_t span1 = min(offsets[g_last] + counts[g_last], capacity);
  const int64_t cap_floats = capacity * kCols;

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int64_t r0 = span0; r0 < span1; r0 += kChunkRows) {
    const int64_t r1 = min(r0 + kChunkRows, span1);
    const int64_t f0 = (r0 * kCols) & ~(int64_t)3;   // 16-byte aligned
    const int n_vec = (int)((r1 * kCols - f0 + 3) >> 2);
    for (int i = threadIdx.x; i < n_vec; i += kGauss) {
      const int64_t f = f0 + 4 * (int64_t)i;
      float4 v;
      if (f + 4 <= cap_floats) {
        v = *reinterpret_cast<const float4*>(dpairs + f);
      } else {   // the array's last, partial vector
        v.x = dpairs[f];
        v.y = f + 1 < cap_floats ? dpairs[f + 1] : 0.0f;
        v.z = f + 2 < cap_floats ? dpairs[f + 2] : 0.0f;
        v.w = 0.0f;
      }
      *reinterpret_cast<float4*>(s_rows + 4 * i) = v;
    }
    __syncthreads();
    const int64_t a = max(s0, r0), b = min(s1, r1);
    for (int64_t s = a; s < b; ++s) {
      const float* row = s_rows + (s * kCols - f0);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = __fadd_rn(acc[c], row[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) s_rows[threadIdx.x * kCols + c] = acc[c];
  __syncthreads();
  const int n_out = (g_last - g0 + 1) * kCols;
  float* o = out + (int64_t)g0 * kCols;
  for (int i = threadIdx.x; i < n_out; i += kGauss) o[i] = s_rows[i];
}

}  // namespace

// dpairs must be 16-byte aligned (the wrapper checks).
extern "C" int gs_segment_sum(const void* dpairs, const void* offsets,
                              const void* counts, int n, long long capacity,
                              void* out, void* stream) {
  const int blocks = (n + kGauss - 1) / kGauss;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<blocks, kGauss, 0, (cudaStream_t)stream>>>(
      (const float*)dpairs, (const int64_t*)offsets, (const int32_t*)counts,
      n, (int64_t)capacity, (float*)out);
  return (int)cudaGetLastError();
}
