"""Tile compositing as a differentiable op: kernels K2 (forward) and K3
(backward) in ``csrc/composite.cu``, K4 (per-gaussian sum) in
``csrc/segsum.cu``, and their plain versions.

``CompositeFunction`` maps per-gaussian feature rows feat9 (N, 9) to the
pre-background color (3, H, W) and final_T (H, W). On CUDA tensors its
forward launches K2 (``composite_cuda``) and its backward launches K3
(``composite_backward_cuda``, per-pair gradients written at their emission
slots) and K4 (``segment_sum_cuda``, each gaussian's contiguous slot segment
summed). K2 runs one 256-thread block per 16x16 quarter of a 32x32 tile (a
thread a pixel), K3 one per tile (a thread 4 pixels); they share their
staging: a pair is evaluated only in the 8x4 sub-boxes where it can reach
the alpha cut (``tile_render.pair_box_mask_plain``), which changes none of
a pixel's decisions. On CPU tensors it runs the plain versions
(``tile_render.composite_plain``, ``composite_backward_plain`` and
``emit.segment_sum_plain``). K2 streams every pair of every tile (no
per-tile cap, so it never sets ``tile_overflow``). Every function here takes
the strided slice of ``emit.py`` (``row_offset``, ``row_stride``; default the
whole image).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gs2mesh_torch import _build
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import (SortedPairs, _check_cuda,
                                               segment_sum)
from gs2mesh_torch.ops.rasterizer.tile_render import (composite_backward_plain,
                                                      composite_plain,
                                                      pair_rows)


@functools.lru_cache(maxsize=None)
def _k2():
    fn = _build.library("composite").gs_composite_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _k3():
    fn = _build.library("composite").gs_composite_backward
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def kernel_info(kernel: str) -> dict:
    """Registers per thread, static shared memory bytes and blocks per SM
    (occupancy API) of ``"K2"`` or ``"K3"`` on the current card."""
    fn = _build.library("composite").gs_composite_kernel_info
    return _build.kernel_info(fn, {"K2": 2, "K3": 3}[kernel])


def _check_tiles(ids_sorted, tile_starts, tile_counts, feat9, width, height,
                 cfg, row_offset, row_stride, **more):
    if cfg.tile != 32:
        raise ValueError("the CUDA compositor runs 32x32 tiles")
    if width <= 0 or height <= 0:
        raise ValueError(f"empty image {width}x{height}")
    if row_offset < 0 or row_stride < 1:
        raise ValueError(f"row_offset {row_offset}, row_stride {row_stride}")
    gx, gy = cfg.grid_size(width, height)
    _check_cuda(ids_sorted=(ids_sorted, torch.int32, (ids_sorted.shape[0],)),
                tile_starts=(tile_starts, torch.int32, (gx * gy,)),
                tile_counts=(tile_counts, torch.int32, (gx * gy,)),
                feat9=(feat9, torch.float32, (feat9.shape[0], 9)), **more)
    return gx, gy


def composite_cuda(ids_sorted, tile_starts, tile_counts, feat9, width: int,
                   height: int, cfg: RasterizerConfig, row_offset: int = 0,
                   row_stride: int = 1):
    """Kernel K2. Returns (color (3, H, W) before background, final_T (H, W))."""
    gx, gy = _check_tiles(ids_sorted, tile_starts, tile_counts, feat9, width,
                          height, cfg, row_offset, row_stride)
    dev = feat9.device
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_T = torch.empty((height, width), dtype=torch.float32, device=dev)
    err = _k2()(ids_sorted.data_ptr(), tile_starts.data_ptr(),
                tile_counts.data_ptr(), feat9.data_ptr(), width, height, gx,
                gy, row_offset, row_stride, cfg.alpha_min, cfg.alpha_clamp,
                cfg.transmittance_eps, color.data_ptr(), final_T.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compositing kernel launch failed: CUDA error {err}")
    composite_cuda.launches += 1
    return color, final_T


composite_cuda.launches = 0


def composite_backward_cuda(ids_sorted, order, tile_starts, tile_counts,
                            num_pairs, feat9, color, final_T, dcolor,
                            dfinal_T, width: int, height: int,
                            cfg: RasterizerConfig, row_offset: int = 0,
                            row_stride: int = 1):
    """Kernel K3: per-pair gradients (K, 9) in feat9 column order, each at
    its EMISSION slot. Of the first min(num_pairs, K) rows (num_pairs the ()
    int64 emission count, read on the device) those of pairs that are
    culled, never reached or accepted at no pixel are zero; the rows past
    them belong to no gaussian and are left unwritten. color / final_T are
    K2's outputs; dcolor / dfinal_T their cotangents."""
    K = ids_sorted.shape[0]
    img, hw = (3, height, width), (height, width)
    dcolor, dfinal_T = dcolor.contiguous(), dfinal_T.contiguous()
    gx, gy = _check_tiles(
        ids_sorted, tile_starts, tile_counts, feat9, width, height, cfg,
        row_offset, row_stride, order=(order, torch.int64, (K,)),
        num_pairs=(num_pairs, torch.int64, ()),
        color=(color, torch.float32, img),
        final_T=(final_T, torch.float32, hw),
        dcolor=(dcolor, torch.float32, img),
        dfinal_T=(dfinal_T, torch.float32, hw))
    dev = feat9.device
    dpairs = torch.empty((K, 9), dtype=torch.float32, device=dev)
    err = _k3()(ids_sorted.data_ptr(), order.data_ptr(),
                tile_starts.data_ptr(), tile_counts.data_ptr(),
                num_pairs.data_ptr(), feat9.data_ptr(), color.data_ptr(),
                final_T.data_ptr(), dcolor.data_ptr(), dfinal_T.data_ptr(),
                width, height, gx, gy, row_offset, row_stride, K,
                cfg.alpha_min, cfg.alpha_clamp,
                cfg.transmittance_eps,
                dpairs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compositing backward kernel launch failed: CUDA "
                           f"error {err}")
    composite_backward_cuda.launches += 1
    return dpairs


composite_backward_cuda.launches = 0


class CompositeFunction(torch.autograd.Function):
    """feat9 (N, 9) -> (color (3, H, W) before background, final_T (H, W),
    tile_overflow ()). Differentiable w.r.t. feat9 only."""

    @staticmethod
    def forward(ctx, feat9, ids_sorted, order, tile_starts, tile_counts,
                num_pairs, offsets, tiles_touched, width: int, height: int,
                cfg: RasterizerConfig, max_per_tile: int, row_offset: int,
                row_stride: int):
        strided = dict(row_offset=row_offset, row_stride=row_stride)
        if feat9.is_cuda:
            color, final_T = composite_cuda(ids_sorted, tile_starts,
                                            tile_counts, feat9, width, height,
                                            cfg, **strided)
            tile_overflow = torch.zeros((), dtype=torch.bool,
                                        device=feat9.device)
        elif feat9.device.type == "cpu":
            c = composite_plain(pair_rows(feat9, ids_sorted), tile_starts,
                                tile_counts, width, height, cfg, max_per_tile,
                                **strided)
            color, final_T, tile_overflow = c.color, c.final_T, c.tile_overflow
        else:
            raise ValueError(f"unsupported device {feat9.device}")
        ctx.save_for_backward(feat9, ids_sorted, order, tile_starts,
                              tile_counts, num_pairs, offsets, tiles_touched,
                              color, final_T)
        ctx.args = (width, height, cfg, max_per_tile, strided)
        ctx.mark_non_differentiable(tile_overflow)
        return color, final_T, tile_overflow

    @staticmethod
    def backward(ctx, dcolor, dfinal_T, _):
        (feat9, ids_sorted, order, tile_starts, tile_counts, num_pairs,
         offsets, tiles_touched, color, final_T) = ctx.saved_tensors
        width, height, cfg, max_per_tile, strided = ctx.args
        if feat9.is_cuda:
            dpairs = composite_backward_cuda(
                ids_sorted, order, tile_starts, tile_counts, num_pairs, feat9,
                color, final_T, dcolor, dfinal_T, width, height, cfg,
                **strided)
        else:
            dsorted = composite_backward_plain(
                pair_rows(feat9, ids_sorted), tile_starts, tile_counts,
                dcolor, dfinal_T, width, height, cfg, max_per_tile,
                **strided)
            dpairs = torch.empty_like(dsorted)
            dpairs[order] = dsorted
        dfeat9 = segment_sum(dpairs, offsets, tiles_touched)
        return (dfeat9,) + (None,) * 13


def composite(feat9, pairs: SortedPairs, tiles_touched, width: int,
              height: int, cfg: RasterizerConfig, max_per_tile: int = 4096,
              row_offset: int = 0, row_stride: int = 1):
    """Kernels K2 / K3 / K4 for CUDA tensors, the plain versions for CPU
    tensors. max_per_tile bounds the plain compositor's per-tile gather.
    Returns (color (3, H, W) before background, final_T (H, W),
    tile_overflow ())."""
    return CompositeFunction.apply(
        feat9, pairs.ids, pairs.order, pairs.tile_starts, pairs.tile_counts,
        pairs.num_pairs, pairs.offsets, tiles_touched, width, height, cfg,
        max_per_tile, row_offset, row_stride)
