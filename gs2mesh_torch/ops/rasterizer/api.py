"""Public rasterization API: preprocess -> emit + sort -> composite -> image.

Port of gs2mesh_tpu ops/rasterizer/api.py::rasterize in its exact-carry
semantics, differentiable w.r.t. means3d / scales / rotations / opacities /
shs / bg and the ``screenspace_offset`` densification probe. CUDA tensors
run kernels K1 (emission), K2 (compositing), and in the backward K3
(compositing backward) and K4 (per-gaussian sum); CPU tensors run the
plain versions of all four. Emission and the sort are not differentiated
(they only order the pairs); autograd carries K4's (N, 9) gradient of the
feature rows through preprocess and the activations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.ops.rasterizer.composite import composite
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emit_pairs,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess


class RasterizeOutput(NamedTuple):
    image: torch.Tensor      # (3, H, W)
    final_T: torch.Tensor    # (H, W) residual transmittance
    radii: torch.Tensor      # (N,) int32 (0 = culled)
    num_pairs: torch.Tensor  # () int64 true pair count (capacity telemetry)
    overflow: torch.Tensor   # () bool: pair_capacity exceeded
    # () bool: a tile exceeded the plain compositor's max_per_tile and its
    # deepest pairs were dropped (kernel K2 streams every pair and never
    # sets it). Like `overflow`, reported, never silent.
    tile_overflow: torch.Tensor


def rasterize(means3d, scales, rotations, opacities, shs, camera: Camera,
              sh_degree: int, bg: Optional[torch.Tensor] = None,
              cfg: RasterizerConfig = RasterizerConfig(),
              scale_modifier: float = 1.0,
              screenspace_offset: Optional[torch.Tensor] = None,
              max_per_tile: int = 4096) -> RasterizeOutput:
    """Render a Gaussian cloud through ``camera`` on the inputs' device.

    screenspace_offset: optional (N, 2) zeros added to the projected means;
      its gradient is dL/dmeans2d in pixel units (the reference's
      screenspace_points retain_grad trick).
    max_per_tile: per-tile pair bound of the plain (CPU) compositor.
    """
    dev = means3d.device
    if camera.device != dev:
        raise ValueError(f"camera on {camera.device}, gaussians on {dev}")
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    prep = preprocess(means3d, scales, rotations, opacities, shs, camera,
                      sh_degree, cfg, scale_modifier)
    if screenspace_offset is not None:
        prep = prep._replace(means2d=prep.means2d + screenspace_offset)
    feat9 = build_feat9(prep)
    W, H = camera.width, camera.height
    gx, gy = cfg.grid_size(W, H)
    with torch.no_grad():
        pairs = sort_pairs(emit_pairs(feat9.detach(), prep.depths, prep.rect,
                                      prep.tiles_touched, W, H, cfg), gx * gy)
    color, final_T, tile_overflow = composite(
        feat9, pairs, prep.tiles_touched, W, H, cfg, max_per_tile)
    image = color + final_T[None] * bg[:, None, None]
    return RasterizeOutput(image=image, final_T=final_T, radii=prep.radius,
                           num_pairs=pairs.num_pairs, overflow=pairs.overflow,
                           tile_overflow=tile_overflow)
