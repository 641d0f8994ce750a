// Kernel K4: per-gaussian segment sum of per-pair gradients.
//
// Replaces gs2mesh_tpu/ops/rasterizer/emit.py::_segsum_kernel (launched by
// segment_sum_tpu from _reduce_sorted_cts / reduce_compact_cts). The TPU
// kernel sums gaussian-id-sorted cotangent chunks into 512-gaussian blocks
// with one-hot MXU matmuls, after a second sort of the pair gradients by
// gaussian id. None of that is needed here: kernel K3 writes each pair's
// gradient at its EMISSION slot, and emission order is gaussian-major
// (gaussian g owns slots [offsets[g], offsets[g] + counts[g])), so each
// gaussian's pairs are already one contiguous segment.
//
// Bound: bytes. Every slot's 36-byte row is read once and every gaussian's
// 36-byte row written once; there is one add per byte-group of 4. Design:
// one thread per gaussian adds its segment in slot order (deterministic, no
// atomics); consecutive threads own consecutive segments, so a warp reads
// one contiguous span of the gradient array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 9;

__global__ void __launch_bounds__(256) segment_sum_kernel(
    const float* __restrict__ dpairs, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ counts, int n, int64_t capacity,
    float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int64_t s0 = offsets[g];
  int64_t s1 = s0 + counts[g];
  if (s1 > capacity) s1 = capacity;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (int64_t s = s0; s < s1; ++s) {
    const float* row = dpairs + s * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = __fadd_rn(acc[c], row[c]);
  }
  float* o = out + (int64_t)g * kCols;
#pragma unroll
  for (int c = 0; c < kCols; ++c) o[c] = acc[c];
}

}  // namespace

extern "C" int gs_segment_sum(const void* dpairs, const void* offsets,
                              const void* counts, int n, long long capacity,
                              void* out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)dpairs, (const int64_t*)offsets, (const int32_t*)counts,
      n, (int64_t)capacity, (float*)out);
  return (int)cudaGetLastError();
}
