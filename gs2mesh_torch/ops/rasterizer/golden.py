"""Golden reference renderer: per pixel over all Gaussians, plain torch.

The port of gs2mesh_tpu ops/rasterizer/golden.py. O(pixels x gaussians):
for tests and tiny scenes only. The compositing semantics of the reference
renderCUDA kernel (cuda_rasterizer/forward.cu:261-374): depth-sorted
front-to-back blending, alpha = min(0.99, op * exp(power)), the alpha <
1/255 skip, the T < 1e-4 early stop that excludes the triggering Gaussian,
and the per-tile rect cull (a Gaussian reaches only the pixels of the tiles
in its rect). Differentiable by autograd; runs on the inputs' device.
"""

from __future__ import annotations

import torch

from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.preprocess import Preprocessed, preprocess


def composite_pixels(prep: Preprocessed, order: torch.Tensor, width: int,
                     height: int, bg: torch.Tensor, cfg: RasterizerConfig):
    """Composite all Gaussians (in ``order``) over every pixel. Returns
    (image (3, H, W), final_T (H, W))."""
    xy = prep.means2d[order]
    conic = prep.conic[order]
    opac = prep.opacity[order]
    rgb = prep.rgb[order]
    rect = prep.rect[order]
    alive = prep.radius[order] > 0
    dev = xy.device

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")            # (H, W)
    tile_x = (px / cfg.tile).to(torch.int32)
    tile_y = (py / cfg.tile).to(torch.int32)

    dx = xy[:, 0, None, None] - px[None]                      # (N, H, W)
    dy = xy[:, 1, None, None] - py[None]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    # The factored quadratic in the float-op order of the other
    # compositors, so the alpha >= 1/255 knife edge decides alike.
    a2 = (-0.5 * a)[:, None, None]
    c2 = (-0.5 * c)[:, None, None]
    power = a2 * (dx * dx) + dy * (c2 * dy - b[:, None, None] * dx)
    alpha = torch.clamp_max(opac[:, None, None] * torch.exp(power),
                            cfg.alpha_clamp)

    in_rect = ((tile_x[None] >= rect[:, 0, None, None])
               & (tile_x[None] < rect[:, 2, None, None])
               & (tile_y[None] >= rect[:, 1, None, None])
               & (tile_y[None] < rect[:, 3, None, None]))
    # No power > 0 skip: the conic comes from the dilated PSD cov2d, so
    # power <= 0 up to rounding, and no compositor of the repo tests it.
    passes = (alpha >= cfg.alpha_min) & in_rect & alive[:, None, None]
    alpha_eff = torch.where(passes, alpha, 0.0)

    # Exclusive transmittance before each Gaussian (in order).
    log1m = torch.log1p(-alpha_eff)
    T_excl = torch.exp(torch.cumsum(log1m, dim=0) - log1m)

    # Early stop: the first g with T * (1 - alpha) < eps ends the pixel,
    # and that g itself is excluded.
    bad = passes & (T_excl * (1.0 - alpha_eff) < cfg.transmittance_eps)
    accepted = passes & ~(torch.cumsum(bad.to(torch.int32), dim=0) > 0)
    alpha_acc = torch.where(accepted, alpha_eff, 0.0)

    # Transmittance over the accepted contributions only.
    log1m_acc = torch.log1p(-alpha_acc)
    T_acc = torch.exp(torch.cumsum(log1m_acc, dim=0) - log1m_acc)
    w = alpha_acc * T_acc                                     # (N, H, W)
    image = torch.einsum("nhw,nc->chw", w, rgb)
    final_T = torch.exp(torch.sum(log1m_acc, dim=0))
    return image + final_T[None] * bg[:, None, None], final_T


def render_golden(means3d, scales, rotations, opacities, shs, camera: Camera,
                  sh_degree: int, bg=None,
                  cfg: RasterizerConfig = RasterizerConfig(),
                  scale_modifier: float = 1.0, cov3d_precomp=None,
                  colors_precomp=None):
    """Preprocess, a stable depth sort and per-pixel compositing. Returns
    (image, final_T, prep)."""
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=means3d.device)
    prep = preprocess(means3d, scales, rotations, opacities, shs, camera,
                      sh_degree, cfg, scale_modifier,
                      cov3d_precomp=cov3d_precomp,
                      colors_precomp=colors_precomp)
    # Culled (radius 0) rows contribute nothing wherever they sort.
    order = torch.argsort(prep.depths.detach(), stable=True)
    image, final_T = composite_pixels(prep, order, camera.width,
                                      camera.height, bg, cfg)
    return image, final_T, prep
