"""Plain PyTorch tile compositor (the CPU path, and the reference kernel K2
is held to).

Port of gs2mesh_tpu ops/rasterizer/tile_render.py::_composite_tile over a
per-tile gather of up to ``max_per_tile`` sorted pairs: front-to-back alpha
compositing with the reference's saturation semantics (alpha clamp 0.99,
1/255 skip, T < 1e-4 stop that excludes the triggering gaussian), written
as log-space prefix sums over the pair axis. Tiles are composited in batches
so the (tiles, pairs, pixels) intermediates stay within a fixed budget.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig

BATCH_ELEMS = 1 << 24   # (tiles x pairs x pixels) elements per batch


class Composited(NamedTuple):
    color: torch.Tensor          # (3, H, W) before background
    final_T: torch.Tensor        # (H, W) residual transmittance
    tile_overflow: torch.Tensor  # () bool: a tile had > max_per_tile pairs
    n_evaluated: torch.Tensor    # () int64 (pair, pixel) evaluations the
                                 # sequential order makes, over image pixels


def _composite_tiles(feat, valid, px, py, cfg: RasterizerConfig):
    """feat (B, L, 9) tile-local pair rows, valid (B, L); px/py (P,).
    Returns (C (B, 3, P), T (B, P), evaluated (B, L, P) bool)."""
    xy_x, xy_y = feat[..., 0, None], feat[..., 1, None]
    ca, cb, cc = feat[..., 2, None], feat[..., 3, None], feat[..., 4, None]
    op = feat[..., 5, None]
    rgb = feat[..., 6:9]                                   # (B, L, 3)

    dx = xy_x - px
    dy = xy_y - py
    # Same float-op order as every compositor of the reference (the alpha
    # >= 1/255 knife edge must decide identically everywhere).
    power = (-0.5 * ca) * (dx * dx) + dy * ((-0.5 * cc) * dy - cb * dx)
    alpha_raw = op * torch.exp(power)
    alpha = torch.clamp_max(alpha_raw, cfg.alpha_clamp)
    passes = (alpha_raw >= torch.tensor(cfg.alpha_min, dtype=torch.float32)) \
        & valid[..., None]
    alpha_eff = torch.where(passes, alpha, 0.0)

    log1m = torch.log1p(-alpha_eff)
    cum_incl = torch.cumsum(log1m, dim=1)
    T_excl = torch.exp(cum_incl - log1m)
    test_T = T_excl * (1.0 - alpha_eff)
    bad = passes & (test_T < cfg.transmittance_eps)
    n_bad = torch.cumsum(bad.to(torch.int32), dim=1)
    accepted = passes & (n_bad == 0)
    evaluated = valid[..., None] & (n_bad - bad.to(torch.int32) == 0)

    alpha_acc = torch.where(accepted, alpha_eff, 0.0)
    log1m_acc = torch.log1p(-alpha_acc)
    cum_acc = torch.cumsum(log1m_acc, dim=1)
    T_acc = torch.exp(cum_acc - log1m_acc)
    w = alpha_acc * T_acc                                  # (B, L, P)
    C = torch.bmm(rgb.transpose(1, 2), w)                  # (B, 3, P)
    return C, torch.exp(cum_acc[:, -1]), evaluated


def composite_plain(ids_sorted, tile_starts, tile_counts, feat9, width: int,
                    height: int, cfg: RasterizerConfig,
                    max_per_tile: int = 4096) -> Composited:
    """ids_sorted (K,) gaussian id per sorted slot; tile ranges (T,);
    feat9 (N, 9) rows with GLOBAL means."""
    dev = feat9.device
    gx, gy = cfg.grid_size(width, height)
    T, P, t = gx * gy, cfg.pixels_per_tile, cfg.tile
    K, N = ids_sorted.shape[0], feat9.shape[0]
    counts = tile_counts.to(torch.int64)
    L = max(1, min(max_per_tile, int(counts.max())))

    p = torch.arange(P, device=dev)
    px, py = (p % t).to(torch.float32), (p // t).to(torch.float32)
    tiles = torch.arange(T, device=dev)
    # Tile origins, so means become tile-local exactly as emission forms
    # them in the reference (mx - tx * tile in f32).
    ox = ((tiles % gx) * t).to(torch.float32)
    oy = ((tiles // gx) * t).to(torch.float32)
    in_image = (((tiles % gx) * t)[:, None] + (p % t) < width) \
        & (((tiles // gx) * t)[:, None] + (p // t) < height)   # (T, P)
    ar = torch.arange(L, device=dev)

    color = torch.empty((T, 3, P), dtype=torch.float32, device=dev)
    final_T = torch.empty((T, P), dtype=torch.float32, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    step = max(1, BATCH_ELEMS // (L * P))
    for b0 in range(0, T, step):
        sl = slice(b0, min(T, b0 + step))
        idx = tile_starts[sl, None].to(torch.int64) + ar
        valid = ar < counts[sl, None]
        idx = torch.where(valid & (idx < K), idx, K - 1)
        g = ids_sorted[idx].to(torch.int64).clamp(0, N - 1)
        feat = feat9[g]                                    # (B, L, 9)
        feat = torch.cat([(feat[..., 0] - ox[sl, None])[..., None],
                          (feat[..., 1] - oy[sl, None])[..., None],
                          feat[..., 2:]], dim=-1)
        C, Tf, evaluated = _composite_tiles(feat, valid, px, py, cfg)
        color[sl], final_T[sl] = C, Tf
        n_eval += (evaluated & in_image[sl, None]).sum()

    color, final_T = assemble_image(color, final_T, gx, gy, width, height, t)
    return Composited(color=color, final_T=final_T,
                      tile_overflow=torch.any(counts > max_per_tile),
                      n_evaluated=n_eval)


def assemble_image(color_tiles, final_T_tiles, gx: int, gy: int, width: int,
                   height: int, tile: int):
    """(T, 3, tile*tile) tile outputs -> (3, H, W) image + (H, W) final_T."""
    c = color_tiles.reshape(gy, gx, 3, tile, tile)
    c = c.permute(2, 0, 3, 1, 4).reshape(3, gy * tile, gx * tile)
    f = final_T_tiles.reshape(gy, gx, tile, tile)
    f = f.permute(0, 2, 1, 3).reshape(gy * tile, gx * tile)
    return c[:, :height, :width].contiguous(), f[:height, :width].contiguous()
