"""Tile compositing forward: kernel K2 (``csrc/composite.cu``) and dispatch.

``composite_cuda`` launches K2, which streams every pair of every tile (no
per-tile cap, so it never sets ``tile_overflow``); ``composite`` takes the
plain compositor (tile_render.composite_plain) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gs2mesh_torch import _build
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import _check_cuda
from gs2mesh_torch.ops.rasterizer.tile_render import composite_plain


@functools.lru_cache(maxsize=None)
def _k2():
    fn = _build.library("composite").gs_composite_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def composite_cuda(ids_sorted, tile_starts, tile_counts, feat9, width: int,
                   height: int, cfg: RasterizerConfig):
    """Kernel K2. Returns (color (3, H, W) before background, final_T (H, W))."""
    if cfg.tile != 32:
        raise ValueError("the CUDA compositor runs 32x32 tiles")
    if width <= 0 or height <= 0:
        raise ValueError(f"empty image {width}x{height}")
    gx, gy = cfg.grid_size(width, height)
    _check_cuda(ids_sorted=(ids_sorted, torch.int32, (ids_sorted.shape[0],)),
                tile_starts=(tile_starts, torch.int32, (gx * gy,)),
                tile_counts=(tile_counts, torch.int32, (gx * gy,)),
                feat9=(feat9, torch.float32, (feat9.shape[0], 9)))
    dev = feat9.device
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_T = torch.empty((height, width), dtype=torch.float32, device=dev)
    err = _k2()(ids_sorted.data_ptr(), tile_starts.data_ptr(),
                tile_counts.data_ptr(), feat9.data_ptr(), width, height, gx,
                gy, cfg.chunk, cfg.alpha_min, cfg.alpha_clamp,
                cfg.transmittance_eps, color.data_ptr(), final_T.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compositing kernel launch failed: CUDA error {err}")
    composite_cuda.launches += 1
    return color, final_T


composite_cuda.launches = 0


def composite(ids_sorted, tile_starts, tile_counts, feat9, width: int,
              height: int, cfg: RasterizerConfig,
              max_per_tile: int = 4096):
    """Kernel K2 for CUDA tensors, the plain compositor for CPU tensors.
    Returns (color (3, H, W) before background, final_T (H, W),
    tile_overflow ())."""
    if feat9.is_cuda:
        color, final_T = composite_cuda(ids_sorted, tile_starts, tile_counts,
                                        feat9, width, height, cfg)
        return color, final_T, torch.zeros((), dtype=torch.bool,
                                           device=feat9.device)
    if feat9.device.type != "cpu":
        raise ValueError(f"unsupported device {feat9.device}")
    c = composite_plain(ids_sorted, tile_starts, tile_counts, feat9, width,
                        height, cfg, max_per_tile)
    return c.color, c.final_T, c.tile_overflow
