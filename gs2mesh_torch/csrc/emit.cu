// Kernel K1: pair emission with the exact alpha-cut cull and (tile | depth)
// sort keys.
//
// Replaces gs2mesh_tpu/ops/rasterizer/emit.py::_decode_kernel (launched by
// emission_decode_pallas); its semantics reference is emit.py::emission_core.
// The TPU kernel decodes emission slots from a compacted run table with
// one-hot matmuls and packs bf16 / minifloat payload columns so that the sort
// carries the features; none of that is needed here: gaussian g owns the
// slots [offsets[g], offsets[g] + tiles_touched[g]), one per tile of its rect
// in row-major order, and the compositor later gathers features by gaussian
// id.
//
// Bound: bytes (an 8-byte key and a 4-byte id per slot, ~60 bytes read per
// gaussian), with the arithmetic not far under it: the box test of a slot
// is four IEEE divisions, an expf and some sixty other float ops. A thread
// per gaussian that loops over its own tiles meets neither bound: a warp
// runs as long as its largest splat while the other lanes idle, and each of
// its store instructions scatters 32 keys over 32 unrelated sectors.
//
// Design: slot-parallel, warp-cooperative expansion.
//  * A warp takes a run of 32 consecutive gaussians. Their offsets, tile
//    counts, rects and depths are loaded one gaussian a lane, and their
//    feat9 rows as one contiguous span, into the warp's shared memory, all
//    coalesced.
//  * The run owns one contiguous span of slots. The lanes sweep it 32 slots
//    at a time from the 32-slot boundary at or below its start, so every
//    store instruction writes 32 consecutive keys (256 bytes, whole sectors)
//    and ids (128 bytes), and every lane has a slot whatever the splat sizes.
//  * A lane finds its slot's gaussian as the last one of the run whose first
//    slot is not past it: a binary search over the lanes' offsets (relative
//    to the span, 32-bit) in five shuffles. Gaussians with no tiles share
//    their successor's offset and so are never the last. The gaussian's
//    constants come from shared memory (odd row strides: no bank conflicts).
//  * The slots from num_pairs to the capacity are filled by a grid-stride
//    loop of all threads; a run whose span crosses the capacity stops there.
//
// Strided slices: with (row_offset, row_stride) local tile row l of the
// rect and of the key is global tile row row_offset + l * row_stride (one
// rank's share of the image under round-robin tile-row ownership, the TPU
// decode's row_offset / cfg.row_stride). The box test takes the global y;
// the key keeps the local tile id. (0, 1) is the whole image.
//
// Numerics: the cull must decide exactly as the reference does; its box test
// lives in cull.cuh (shared with K2 and K3), written in separately rounded
// __f*_rn intrinsics in the reference's operation order.
//
// What still holds it back: the box test's divisions and expf per slot, and
// the 64-bit key, of which the sort needs 32 bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;         // gaussians of a warp's run, one a lane
constexpr int kFeat = 9;         // floats of a feat9 row (odd: no conflicts)
constexpr int kInts = 5;         // x0, y0, rect width, depth bits, padding
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) emit_pairs_kernel(
    const int64_t* __restrict__ offsets, const int32_t* __restrict__ tiles,
    const int4* __restrict__ rect, const float* __restrict__ depths,
    const float* __restrict__ feat9, const int64_t* __restrict__ num_pairs_p,
    const int64_t* __restrict__ sent_key_p, int n, int64_t capacity, int gx,
    int num_tiles, int tb, int tile, int row_offset, int row_stride,
    int64_t* __restrict__ keys, int32_t* __restrict__ ids) {
  __shared__ float s_feat[kWarps][kRun * kFeat];
  __shared__ int s_int[kWarps][kRun * kInts];

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // Slots past the last pair: sentinel tile, last emitting gaussian's depth.
  const int64_t sent = *sent_key_p;
  for (int64_t s = *num_pairs_p + tid; s < capacity; s += stride) {
    keys[s] = sent;
    ids[s] = -1;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (tid >> 5) * kRun;   // the run's first gaussian
  if (first >= n) return;
  const int in_run = (int)min((int64_t)kRun, n - first);
  const int g = (int)first + lane;
  const bool has = lane < in_run;

  const int64_t off = has ? offsets[g] : 0;
  const int cnt = has ? max(tiles[g], 0) : 0;
  const int64_t span_start = __shfl_sync(kFull, off, 0);
  const int64_t span_end =
      min(__shfl_sync(kFull, off + cnt, in_run - 1), capacity);
  if (span_end <= span_start) return;
  // First slot relative to the span; past every slot for the lanes beyond n.
  const int rel =
      has ? (int)min(off - span_start, (int64_t)INT_MAX) : INT_MAX;

  float* w_feat = s_feat[warp];
  int* w_int = s_int[warp];
  const float* src = feat9 + first * kFeat;
  for (int i = lane; i < in_run * kFeat; i += 32) w_feat[i] = src[i];
  if (has) {
    const int4 r = rect[g];
    w_int[lane * kInts + 0] = r.x;
    w_int[lane * kInts + 1] = r.y;
    w_int[lane * kInts + 2] = max(r.z - r.x, 1);
    w_int[lane * kInts + 3] = (int)(__float_as_uint(depths[g]) >> tb);
  }
  __syncwarp();

  const int shift = 32 - tb;
  const float tf = (float)tile;
  for (int64_t s0 = span_start & ~(int64_t)31; s0 < span_end; s0 += 32) {
    const int64_t s = s0 + lane;
    const int r = (int)(s - span_start);     // negative before the span
    int j = 0;                               // last gaussian with rel <= r
#pragma unroll
    for (int b = 16; b > 0; b >>= 1)
      if (__shfl_sync(kFull, rel, j + b) <= r) j += b;
    const int local = r - __shfl_sync(kFull, rel, j);
    if (r < 0 || s >= span_end) continue;

    const int* gi = w_int + j * kInts;
    const float* f = w_feat + j * kFeat;
    const unsigned rw = (unsigned)gi[2];
    const int tx = gi[0] + (int)((unsigned)local % rw);
    const int ty = gi[1] + (int)((unsigned)local / rw);
    // Local tile row ty lies at global row row_offset + ty * row_stride
    // (strided slices); the box test takes the global geometry, the key the
    // local tile id.
    const int ty_global = row_offset + ty * row_stride;
    const float x_lo = __fsub_rn(__fmul_rn((float)tx, tf), f[0]);
    const float x_hi = __fadd_rn(x_lo, tf - 1.0f);
    const float y_lo = __fsub_rn(__fmul_rn((float)ty_global, tf), f[1]);
    const float y_hi = __fadd_rn(y_lo, tf - 1.0f);
    const bool alive =
        gs_cull::box_alive(f[2], f[3], f[4], f[5], x_lo, x_hi, y_lo, y_hi);
    const int64_t tile_id = alive ? (int64_t)ty * gx + tx : (int64_t)num_tiles;
    keys[s] = (tile_id << shift) | (int64_t)(unsigned)gi[3];
    ids[s] = (int)first + j;
  }
}

}  // namespace

// rect must be 16-byte aligned (one int4 load per gaussian).
extern "C" int gs_emit_pairs(const void* offsets, const void* tiles,
                             const void* rect, const void* depths,
                             const void* feat9, const void* num_pairs,
                             const void* sent_key, int n, long long capacity,
                             int gx, int num_tiles, int tb, int tile,
                             int row_offset, int row_stride, void* keys,
                             void* ids, void* stream) {
  const long long by_n = ((long long)n + kThreads - 1) / kThreads;
  const long long by_k = (capacity + kThreads - 1) / kThreads;
  // A warp per 32 gaussians, and at least enough blocks (up to 1024) for
  // the tail fill of the unused slots to spread over the card.
  long long blocks = by_k < 1024 ? by_k : 1024;
  if (blocks < by_n) blocks = by_n;
  if (blocks < 1) blocks = 1;
  emit_pairs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)offsets, (const int32_t*)tiles, (const int4*)rect,
      (const float*)depths, (const float*)feat9, (const int64_t*)num_pairs,
      (const int64_t*)sent_key, n, (int64_t)capacity, gx, num_tiles, tb, tile,
      row_offset, row_stride, (int64_t*)keys, (int32_t*)ids);
  return (int)cudaGetLastError();
}

// out[0..2] = K1's registers per thread, static shared memory bytes and the
// blocks the occupancy API fits on one SM. Returns the CUDA error.
extern "C" int gs_emit_kernel_info(int, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, emit_pairs_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], emit_pairs_kernel, kThreads, 0);
  return (int)err;
}
