"""Pair emission -> stable (tile, depth) sort -> per-tile pair ranges.

Port of the exact-carry emission of the reference (gs2mesh_tpu
ops/rasterizer/emit.py::emission_core and tile_ranges_from_sorted_keys; the
CUDA reference's duplicateWithKeys + radix sort + identifyTileRanges):

  * every gaussian with ``tiles_touched > 0`` emits one slot per tile of its
    rect, at ``offsets[g] + local`` (``offsets`` the exclusive prefix sum of
    ``tiles_touched``), row-major inside the rect;
  * a pair whose maximum alpha over its tile's pixel box is below the
    compositors' 1/255 cut (with a 2% margin) is culled to the sentinel
    tile ``num_tiles``, as are the slots past the last pair;
  * the key is the reference's 32-bit ``(tile << (32-tb)) | (depth_bits >>
    tb)``, held in an int64, so ``torch.sort(stable=True)`` gives exactly
    the reference's order.

``emission_cuda`` launches kernel K1 (``csrc/emit.cu``); ``emission_plain``
is the same function in PyTorch ops. ``emit_pairs`` picks by device.

Strided slices (the multi-rank step, ``parallel/sharded_train.py``): with
``(row_offset, row_stride)`` the grid is one rank's share of the image
under round-robin tile-row ownership, local tile row ``l`` being global row
``row_offset + l * row_stride`` (the JAX package's ``row_offset`` and
``RasterizerConfig.row_stride``). ``rect`` holds local rows; the cull takes
the global y; keys and tile ids stay local. ``key_tiles`` sizes the key's
tile field (default: this grid's tile count, as the JAX package does); a
slice sized for the whole image's count orders its pairs exactly as the
unsharded render does.

Emission order is gaussian-major, so the backward's per-gaussian reduction
is a sum over contiguous slot segments: ``segment_sum_cuda`` launches
kernel K4 (``csrc/segsum.cu``) on per-pair gradients written at their
emission slots; ``segment_sum_plain`` is the same sum in PyTorch ops
(float64), and ``segment_sum_slot_order`` the float32 sum in slot order
that K4 must equal bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gs2mesh_torch import _build
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig

# Pair-cull threshold: the 1/255 alpha cut less a 2% margin that absorbs
# float disagreement with the compositors' own per-pixel test.
ALIVE_MIN = 0.98 / 255.0


class Emission(NamedTuple):
    """Emission-order slots (everything known before the sort)."""
    keys: torch.Tensor       # (K,) int64 packed [tile_id | depth msbs]
    ids: torch.Tensor        # (K,) int32 gaussian id, -1 past num_pairs
    offsets: torch.Tensor    # (N,) int64 first slot of each gaussian
    num_pairs: torch.Tensor  # () int64 true emission count
    overflow: torch.Tensor   # () bool: pair_capacity exceeded


class SortedPairs(NamedTuple):
    ids: torch.Tensor          # (K,) int32 gaussian id per sorted slot
    order: torch.Tensor        # (K,) int64 emission slot of each sorted slot
    offsets: torch.Tensor      # (N,) int64 first emission slot per gaussian
    tile_starts: torch.Tensor  # (T,) int32 start into the sorted pairs
    tile_counts: torch.Tensor  # (T,) int32 pairs of each tile
    num_pairs: torch.Tensor    # () int64
    overflow: torch.Tensor     # () bool


def key_bits(num_tiles: int) -> int:
    """Depth bits dropped from the key: the tile id takes the top bits."""
    return int(num_tiles + 1).bit_length()


def _depth_msbs(depths: torch.Tensor, tb: int) -> torch.Tensor:
    """f32 bit pattern as an unsigned 32-bit value, shifted right by tb."""
    return (depths.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) >> tb


def build_feat9(prep) -> torch.Tensor:
    """(N, 9) rows [mx, my, conic a, b, c, opacity, r, g, b] (global means)."""
    return torch.cat([prep.means2d, prep.conic, prep.opacity[:, None],
                      prep.rgb], dim=1).contiguous()


def box_alive_plain(ca, cb, cc, op, x_lo, x_hi, y_lo, y_hi) -> torch.Tensor:
    """Can a gaussian reach the 1/255 alpha cut (less the 2% margin) in the
    box [x_lo, x_hi] x [y_lo, y_hi] of pixel-minus-mean offsets? The minimum
    of the convex conic quadratic over the box is 0 if the mean is inside,
    else it lies on an edge. Broadcasts; the same arithmetic as
    ``csrc/cull.cuh::box_alive`` (K1's cull, K2's and K3's sub-box mask)."""
    def qval(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    def edge_x(dx):                   # min over dy in [y_lo, y_hi] at dx
        return qval(dx, clip(-cb * dx / torch.clamp_min(cc, 1e-12),
                             y_lo, y_hi))

    def edge_y(dy):
        return qval(clip(-cb * dy / torch.clamp_min(ca, 1e-12), x_lo, x_hi),
                    dy)

    inside = (x_lo <= 0) & (0 <= x_hi) & (y_lo <= 0) & (0 <= y_hi)
    qmin = torch.minimum(torch.minimum(edge_x(x_lo), edge_x(x_hi)),
                         torch.minimum(edge_y(y_lo), edge_y(y_hi)))
    qmin = torch.where(inside, 0.0, qmin)
    return op * torch.exp(-qmin) >= torch.tensor(ALIVE_MIN,
                                                 dtype=torch.float32)


def _strided_grid(width, height, cfg, row_offset, row_stride, key_tiles):
    """(gx, num_tiles, tb) of a (strided) grid, the arguments checked."""
    gx, gy = cfg.grid_size(width, height)
    num_tiles = gx * gy
    key_tiles = num_tiles if key_tiles is None else int(key_tiles)
    if row_offset < 0 or row_stride < 1 or key_tiles < num_tiles:
        raise ValueError(f"row_offset {row_offset}, row_stride {row_stride}, "
                         f"key_tiles {key_tiles} for {num_tiles} tiles")
    return gx, num_tiles, key_bits(key_tiles)


def emission_plain(feat9, depths, rect, tiles_touched, width: int,
                   height: int, cfg: RasterizerConfig, row_offset: int = 0,
                   row_stride: int = 1, key_tiles=None) -> Emission:
    """Per-slot decode with searchsorted over the prefix sum, then the same
    cull and key as kernel K1."""
    K = cfg.pair_capacity
    gx, num_tiles, tb = _strided_grid(width, height, cfg, row_offset,
                                      row_stride, key_tiles)
    dev = depths.device
    f32 = torch.float32

    cum = torch.cumsum(tiles_touched.to(torch.int64), 0)
    num_pairs = cum[-1]
    offsets = cum - tiles_touched
    slot = torch.arange(K, dtype=torch.int64, device=dev)
    valid = slot < num_pairs
    # Slots past the last pair decode to the last emitting gaussian, as the
    # reference's run-table decode does (their keys carry its depth bits).
    g = torch.searchsorted(cum, torch.minimum(slot, num_pairs - 1),
                           right=True)
    local = slot - offsets[g]
    r = rect[g].to(torch.int64)
    rw = torch.clamp_min(r[:, 2] - r[:, 0], 1)
    tx = r[:, 0] + local % rw
    ty = r[:, 1] + local // rw

    f = feat9[g]
    mx, my = f[:, 0], f[:, 1]
    ca, cb, cc, op = f[:, 2], f[:, 3], f[:, 4], f[:, 5]
    t = cfg.tile
    x_lo = tx.to(f32) * t - mx
    x_hi = x_lo + (t - 1)
    y_lo = (row_offset + ty * row_stride).to(f32) * t - my
    y_hi = y_lo + (t - 1)

    alive = box_alive_plain(ca, cb, cc, op, x_lo, x_hi, y_lo, y_hi)

    tile_id = torch.where(valid & alive, ty * gx + tx, num_tiles)
    # An empty emission (a slice no gaussian reaches) has depth bits 0.
    dbits = torch.where(num_pairs > 0, _depth_msbs(depths[g], tb), 0)
    keys = (tile_id << (32 - tb)) | dbits
    ids = torch.where(valid, g, -1).to(torch.int32)
    return Emission(keys=keys, ids=ids, offsets=offsets, num_pairs=num_pairs,
                    overflow=num_pairs > K)


@functools.lru_cache(maxsize=None)
def _k1():
    fn = _build.library("emit").gs_emit_pairs
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def emission_cuda(feat9, depths, rect, tiles_touched, width: int,
                  height: int, cfg: RasterizerConfig, row_offset: int = 0,
                  row_stride: int = 1, key_tiles=None) -> Emission:
    """Kernel K1: a warp expands a run of 32 gaussians into its contiguous
    span of slots, 32 consecutive keys and ids per store."""
    N = depths.shape[0]
    K = cfg.pair_capacity
    gx, num_tiles, tb = _strided_grid(width, height, cfg, row_offset,
                                      row_stride, key_tiles)
    _check_cuda(feat9=(feat9, torch.float32, (N, 9)),
                depths=(depths, torch.float32, (N,)),
                rect=(rect, torch.int32, (N, 4)),
                tiles_touched=(tiles_touched, torch.int32, (N,)))
    if N == 0 or N >= 2 ** 31 or K >= 2 ** 31:
        raise ValueError(f"unsupported sizes N={N}, pair_capacity={K}")
    if rect.data_ptr() % 16:
        raise ValueError("rect must be 16-byte aligned")

    cum = torch.cumsum(tiles_touched.to(torch.int64), 0)
    offsets = cum - tiles_touched
    num_pairs = cum[-1:]
    g_last = torch.searchsorted(cum, num_pairs - 1, right=True)
    sent_key = (num_tiles << (32 - tb)) | torch.where(
        num_pairs > 0, _depth_msbs(depths[g_last], tb), 0)
    keys = torch.empty(K, dtype=torch.int64, device=depths.device)
    ids = torch.empty(K, dtype=torch.int32, device=depths.device)
    err = _k1()(offsets.data_ptr(), tiles_touched.data_ptr(),
                rect.data_ptr(), depths.data_ptr(), feat9.data_ptr(),
                num_pairs.data_ptr(), sent_key.data_ptr(), N, K, gx,
                num_tiles, tb, cfg.tile, row_offset, row_stride,
                keys.data_ptr(), ids.data_ptr(),
                torch.cuda.current_stream(depths.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"emission kernel launch failed: CUDA error {err}")
    emission_cuda.launches += 1
    return Emission(keys=keys, ids=ids, offsets=offsets,
                    num_pairs=num_pairs[0], overflow=num_pairs[0] > K)


emission_cuda.launches = 0


def emission_kernel_info() -> dict:
    """K1's registers per thread, static shared memory bytes and blocks per
    SM (occupancy API) on the current card."""
    return _build.kernel_info(_build.library("emit").gs_emit_kernel_info)


def _check_cuda(**tensors):
    """Device / dtype / shape / contiguity checks before raw pointers go to a
    kernel; ``tensors`` maps name -> (tensor, dtype, shape)."""
    dev = None
    for name, (x, dtype, shape) in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, expected cuda")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, others on {dev}")
        dev = x.device
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)}, expected "
                             f"{dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def emit_pairs(feat9, depths, rect, tiles_touched, width: int, height: int,
               cfg: RasterizerConfig, row_offset: int = 0,
               row_stride: int = 1, key_tiles=None) -> Emission:
    """Kernel K1 for CUDA tensors, the plain version for CPU tensors."""
    args = (feat9, depths, rect, tiles_touched, width, height, cfg,
            row_offset, row_stride, key_tiles)
    if depths.is_cuda:
        return emission_cuda(*args)
    if depths.device.type != "cpu":
        raise ValueError(f"unsupported device {depths.device}")
    return emission_plain(*args)


def sort_pairs(em: Emission, num_tiles: int, key_tiles=None) -> SortedPairs:
    """Stable sort on the (tile | depth) key and per-tile [start, start +
    count) ranges of the sorted pairs (library sort and search); key_tiles
    as given to the emission."""
    keys_s, order = torch.sort(em.keys, stable=True)
    tb = key_bits(num_tiles if key_tiles is None else key_tiles)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=keys_s.device) << (32 - tb)
    edges = torch.searchsorted(keys_s, bounds, out_int32=True)
    return SortedPairs(ids=em.ids[order], order=order, offsets=em.offsets,
                       tile_starts=edges[:-1],
                       tile_counts=edges[1:] - edges[:-1],
                       num_pairs=em.num_pairs, overflow=em.overflow)


def segment_sum_plain(dpairs, offsets, counts) -> torch.Tensor:
    """Plain version of kernel K4: (K, 9) per-pair rows in emission order ->
    (N, 9) per-gaussian sums over the slots [offsets[g], offsets[g] +
    counts[g]) (clipped to K). Accumulates in float64 on the CPU, whose
    index_add_ is sequential, so the result is the same on every run; it
    is returned on the input's device."""
    K, N = dpairs.shape[0], counts.shape[0]
    cum = (offsets.to(torch.int64) + counts.to(torch.int64)).cpu()
    slot = torch.arange(K, dtype=torch.int64)
    g = torch.searchsorted(cum, slot, right=True)
    live = g < N
    out = torch.zeros((N, dpairs.shape[1]), dtype=torch.float64)
    out.index_add_(0, g[live], dpairs.detach().cpu().to(torch.float64)[live])
    return out.to(torch.float32).to(dpairs.device)


def segment_sum_slot_order(dpairs, offsets, counts) -> torch.Tensor:
    """The sum K4 computes, float32 add by float32 add from 0 in slot order
    over [offsets[g], offsets[g] + counts[g]) (clipped to K): K4's strict
    reference, equal to it bit for bit. One vectorised add per rank inside
    the segments, over the gaussians that still have a row at that rank.
    Same contract as segment_sum_plain; runs on the input's device."""
    K, N = dpairs.shape[0], counts.shape[0]
    off = offsets.to(torch.int64).clamp(max=K)
    n = (off + counts.to(torch.int64)).clamp(max=K) - off
    out = torch.zeros((N, dpairs.shape[1]), dtype=torch.float32,
                      device=dpairs.device)
    if N == 0:
        return out
    n_sorted, by_len = torch.sort(n, descending=True)
    # still_active[j]: how many gaussians have more than j rows.
    ranks = torch.arange(int(n_sorted[0]), device=n.device)
    still_active = torch.searchsorted(-n_sorted, -ranks, right=False).tolist()
    rows = dpairs.detach().to(torch.float32)
    for j, m in enumerate(still_active):
        g = by_len[:m]
        out[g] = out[g] + rows[off[g] + j]
    return out


@functools.lru_cache(maxsize=None)
def _k4():
    fn = _build.library("segsum").gs_segment_sum
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def segment_sum_cuda(dpairs, offsets, counts) -> torch.Tensor:
    """Kernel K4: a block stages the contiguous slot span of its 256
    gaussians in shared memory and each thread adds its own gaussian's rows
    in slot order (deterministic, no atomics; bit-equal to
    segment_sum_slot_order). ``offsets`` must be the exclusive prefix sum of
    ``counts``, as emission makes it. Same contract as segment_sum_plain."""
    K, N = dpairs.shape[0], counts.shape[0]
    _check_cuda(dpairs=(dpairs, torch.float32, (K, 9)),
                offsets=(offsets, torch.int64, (N,)),
                counts=(counts, torch.int32, (N,)))
    if N >= 2 ** 31:
        raise ValueError(f"unsupported gaussian count {N}")
    if dpairs.data_ptr() % 16:
        raise ValueError("dpairs must be 16-byte aligned")
    out = torch.empty((N, 9), dtype=torch.float32, device=dpairs.device)
    if N == 0:
        return out
    err = _k4()(dpairs.data_ptr(), offsets.data_ptr(), counts.data_ptr(), N,
                K, out.data_ptr(),
                torch.cuda.current_stream(dpairs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: CUDA error "
                           f"{err}")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0


def segment_sum(dpairs, offsets, counts) -> torch.Tensor:
    """Kernel K4 for CUDA tensors, the plain version for CPU tensors."""
    if dpairs.is_cuda:
        return segment_sum_cuda(dpairs, offsets, counts)
    if dpairs.device.type != "cpu":
        raise ValueError(f"unsupported device {dpairs.device}")
    return segment_sum_plain(dpairs, offsets, counts)
