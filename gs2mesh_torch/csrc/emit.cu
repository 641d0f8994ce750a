// Kernel K1: pair emission with the exact alpha-cut cull and (tile | depth)
// sort keys.
//
// Replaces gs2mesh_tpu/ops/rasterizer/emit.py::_decode_kernel (launched by
// emission_decode_pallas); its semantics reference is emit.py::emission_core.
// The TPU kernel decodes emission slots from a compacted run table with
// one-hot matmuls and packs bf16 / minifloat payload columns so that the sort
// carries the features; none of that is needed here. This is the
// duplicateWithKeys form: one thread per gaussian writes the slots
// [offsets[g], offsets[g] + tiles_touched[g]) in row-major rect order, and the
// compositor later gathers features by gaussian id.
//
// Bound: bytes. Per pair it writes an 8-byte key and a 4-byte id; per
// gaussian it reads ~68 bytes. The arithmetic per pair (four clamped edge
// minima and one expf) is small next to that. Design: consecutive threads
// read consecutive gaussians (coalesced loads); a thread's writes go to
// consecutive slots, so a warp's stores land on a handful of contiguous runs.
// Load balance follows tiles_touched, which is a few tiles for most splats.
//
// Numerics: the cull must decide exactly as the reference does; its box test
// lives in cull.cuh (shared with K3), written in separately rounded __f*_rn
// intrinsics in the reference's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"

namespace {

__global__ void __launch_bounds__(256) emit_pairs_kernel(
    const int64_t* __restrict__ offsets, const int32_t* __restrict__ tiles,
    const int32_t* __restrict__ rect, const float* __restrict__ depths,
    const float* __restrict__ feat9, const int64_t* __restrict__ num_pairs_p,
    const int64_t* __restrict__ sent_key_p, int n, int64_t capacity, int gx,
    int num_tiles, int tb, int tile, int64_t* __restrict__ keys,
    int32_t* __restrict__ ids) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // Slots past the last pair: sentinel tile, last emitting gaussian's depth.
  const int64_t sent = *sent_key_p;
  for (int64_t s = *num_pairs_p + tid; s < capacity; s += stride) {
    keys[s] = sent;
    ids[s] = -1;
  }

  if (tid >= n) return;
  const int g = (int)tid;
  const int cnt = tiles[g];
  const int64_t off = offsets[g];
  if (cnt <= 0 || off >= capacity) return;

  const int x0 = rect[4 * g + 0], y0 = rect[4 * g + 1], x1 = rect[4 * g + 2];
  const int rw = max(x1 - x0, 1);
  const float* f = feat9 + (int64_t)g * 9;
  const float mx = f[0], my = f[1], ca = f[2], cb = f[3], cc = f[4], op = f[5];
  const int64_t dbits = (int64_t)(__float_as_uint(depths[g]) >> tb);
  const int shift = 32 - tb;
  const float tf = (float)tile;
  const int64_t room = capacity - off;
  const int n_write = room < cnt ? (int)room : cnt;

  for (int local = 0; local < n_write; ++local) {
    const int tx = x0 + local % rw;
    const int ty = y0 + local / rw;
    const float x_lo = __fsub_rn(__fmul_rn((float)tx, tf), mx);
    const float x_hi = __fadd_rn(x_lo, tf - 1.0f);
    const float y_lo = __fsub_rn(__fmul_rn((float)ty, tf), my);
    const float y_hi = __fadd_rn(y_lo, tf - 1.0f);
    const bool alive =
        gs_cull::box_alive(ca, cb, cc, op, x_lo, x_hi, y_lo, y_hi);
    const int64_t tile_id = alive ? (int64_t)ty * gx + tx : (int64_t)num_tiles;
    keys[off + local] = (tile_id << shift) | dbits;
    ids[off + local] = g;
  }
}

}  // namespace

extern "C" int gs_emit_pairs(const void* offsets, const void* tiles,
                             const void* rect, const void* depths,
                             const void* feat9, const void* num_pairs,
                             const void* sent_key, int n, long long capacity,
                             int gx, int num_tiles, int tb, int tile,
                             void* keys, void* ids, void* stream) {
  const int threads = 256;
  const long long by_n = (n + threads - 1) / threads;
  const long long by_k = (capacity + threads - 1) / threads;
  // One thread per gaussian, and at least enough blocks (up to 1024) for
  // the tail fill of the unused slots to spread over the card.
  long long blocks = by_k < 1024 ? by_k : 1024;
  if (blocks < by_n) blocks = by_n;
  if (blocks < 1) blocks = 1;
  emit_pairs_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)offsets, (const int32_t*)tiles, (const int32_t*)rect,
      (const float*)depths, (const float*)feat9, (const int64_t*)num_pairs,
      (const int64_t*)sent_key, n, (int64_t)capacity, gx, num_tiles, tb, tile,
      (int64_t*)keys, (int32_t*)ids);
  return (int)cudaGetLastError();
}
