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
    num_pairs: torch.Tensor  # () int64 true emission count
    overflow: torch.Tensor   # () bool: pair_capacity exceeded


class SortedPairs(NamedTuple):
    ids: torch.Tensor          # (K,) int32 gaussian id per sorted slot
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


def emission_plain(feat9, depths, rect, tiles_touched, width: int,
                   height: int, cfg: RasterizerConfig) -> Emission:
    """Per-slot decode with searchsorted over the prefix sum, then the same
    cull and key as kernel K1."""
    K = cfg.pair_capacity
    gx, gy = cfg.grid_size(width, height)
    num_tiles = gx * gy
    tb = key_bits(num_tiles)
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
    y_lo = ty.to(f32) * t - my
    y_hi = y_lo + (t - 1)

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
    alive = op * torch.exp(-qmin) >= torch.tensor(ALIVE_MIN, dtype=f32)

    tile_id = torch.where(valid & alive, ty * gx + tx, num_tiles)
    keys = (tile_id << (32 - tb)) | _depth_msbs(depths[g], tb)
    ids = torch.where(valid, g, -1).to(torch.int32)
    return Emission(keys=keys, ids=ids, num_pairs=num_pairs,
                    overflow=num_pairs > K)


@functools.lru_cache(maxsize=None)
def _k1():
    fn = _build.library("emit").gs_emit_pairs
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def emission_cuda(feat9, depths, rect, tiles_touched, width: int,
                  height: int, cfg: RasterizerConfig) -> Emission:
    """Kernel K1: one thread per gaussian writes its pairs' keys and ids."""
    N = depths.shape[0]
    K = cfg.pair_capacity
    gx, gy = cfg.grid_size(width, height)
    num_tiles = gx * gy
    tb = key_bits(num_tiles)
    _check_cuda(feat9=(feat9, torch.float32, (N, 9)),
                depths=(depths, torch.float32, (N,)),
                rect=(rect, torch.int32, (N, 4)),
                tiles_touched=(tiles_touched, torch.int32, (N,)))
    if N == 0 or N >= 2 ** 31 or K >= 2 ** 31:
        raise ValueError(f"unsupported sizes N={N}, pair_capacity={K}")

    cum = torch.cumsum(tiles_touched.to(torch.int64), 0)
    offsets = cum - tiles_touched
    num_pairs = cum[-1:]
    g_last = torch.searchsorted(cum, num_pairs - 1, right=True)
    sent_key = (num_tiles << (32 - tb)) | _depth_msbs(depths[g_last], tb)
    keys = torch.empty(K, dtype=torch.int64, device=depths.device)
    ids = torch.empty(K, dtype=torch.int32, device=depths.device)
    err = _k1()(offsets.data_ptr(), tiles_touched.data_ptr(),
                rect.data_ptr(), depths.data_ptr(), feat9.data_ptr(),
                num_pairs.data_ptr(), sent_key.data_ptr(), N, K, gx,
                num_tiles, tb, cfg.tile, keys.data_ptr(), ids.data_ptr(),
                torch.cuda.current_stream(depths.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"emission kernel launch failed: CUDA error {err}")
    emission_cuda.launches += 1
    return Emission(keys=keys, ids=ids, num_pairs=num_pairs[0],
                    overflow=num_pairs[0] > K)


emission_cuda.launches = 0


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
               cfg: RasterizerConfig) -> Emission:
    """Kernel K1 for CUDA tensors, the plain version for CPU tensors."""
    if depths.is_cuda:
        return emission_cuda(feat9, depths, rect, tiles_touched, width,
                             height, cfg)
    if depths.device.type != "cpu":
        raise ValueError(f"unsupported device {depths.device}")
    return emission_plain(feat9, depths, rect, tiles_touched, width, height,
                          cfg)


def sort_pairs(em: Emission, num_tiles: int) -> SortedPairs:
    """Stable sort on the (tile | depth) key and per-tile [start, start +
    count) ranges of the sorted pairs (library sort and search)."""
    keys_s, order = torch.sort(em.keys, stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=keys_s.device) << (32 - key_bits(num_tiles))
    edges = torch.searchsorted(keys_s, bounds, out_int32=True)
    return SortedPairs(ids=em.ids[order], tile_starts=edges[:-1],
                       tile_counts=edges[1:] - edges[:-1],
                       num_pairs=em.num_pairs, overflow=em.overflow)
