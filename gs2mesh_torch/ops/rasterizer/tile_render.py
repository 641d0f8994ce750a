"""Plain PyTorch tile compositor, forward and backward (the CPU path, and
the reference kernels K2 and K3 are held to).

Port of gs2mesh_tpu ops/rasterizer/tile_render.py::_composite_tile over a
per-tile gather of up to ``max_per_tile`` sorted pairs: front-to-back alpha
compositing with the reference's saturation semantics (alpha clamp 0.99,
1/255 skip, T < 1e-4 stop that excludes the triggering gaussian), written
as log-space prefix sums over the pair axis. Tiles are composited in batches
so the (tiles, pairs, pixels) intermediates stay within a fixed budget.

The compositor reads per-pair rows ``pair_feat = feat9[ids_sorted]`` (see
``pair_rows``), so autograd through it yields per-pair gradients at sorted
positions: ``composite_backward_plain`` is that autograd, taken one tile
batch at a time (the plain version of kernel K3; the counterpart of the
JAX package's ``render_tiles_xla`` autodiff). Like the reference backward
(and K3), the gradient does not gate on the 0.99 alpha clamp.

K2 and K3 evaluate a pair only in the 8x4-pixel sub-boxes of the tile in
which it can reach the alpha cut; ``pair_box_mask_plain`` is the plain
version of that mask (the emission cull's box test at sub-box size, asked
only of the sub-boxes that meet the box around the pair's reach,
``reach_extents_plain``), and ``composite_plain`` can count the evaluations
a compositor restricted by it makes. With ``drop_culled=True``
``composite_plain`` drops every evaluation the mask rejects, as K2 does: its
outputs must not change by a bit.

Strided slices: with ``(row_offset, row_stride)`` the (width, height) image
is one rank's share under round-robin tile-row ownership, local tile row
``l`` being global row ``row_offset + l * row_stride``; tile origins (and so
tile-local means and pixel centres) take the global y, the image stays the
slice's, as in K2 and K3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import ALIVE_MIN, box_alive_plain

BATCH_ELEMS = 1 << 24   # (tiles x pairs x pixels) elements per batch
BOX_W, BOX_H = 8, 4     # K2's and K3's sub-box of a tile: one pixel per
                        # warp lane


class Composited(NamedTuple):
    color: torch.Tensor          # (3, H, W) before background
    final_T: torch.Tensor        # (H, W) residual transmittance
    tile_overflow: torch.Tensor  # () bool: a tile had > max_per_tile pairs
    n_evaluated: torch.Tensor    # () int64 (pair, pixel) evaluations the
                                 # sequential order makes, over image pixels
    n_accepted: torch.Tensor     # () int64 of those, the pairs composited
    n_box_evaluated: torch.Tensor  # () int64 evaluations when a pair is
                                 # evaluated over whole sub-boxes: those its
                                 # box mask keeps and in which some pixel
                                 # still evaluates it (0 without box_mask)
    tile_evaluated: torch.Tensor  # (T,) int64 n_evaluated of each tile
    tile_accepted: torch.Tensor   # (T,) int64 n_accepted of each tile


class _ClampNoGate(torch.autograd.Function):
    """min(x, hi) whose gradient passes through unchanged (the reference
    backward differentiates op*G, backward.cu:500-505)."""

    @staticmethod
    def forward(ctx, x, hi: float):
        return torch.clamp_max(x, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pair_rows(feat9: torch.Tensor, ids_sorted: torch.Tensor) -> torch.Tensor:
    """(K, 9) feature row of each sorted slot (slots past the last pair,
    id -1, read row 0; the compositor masks them)."""
    return feat9[ids_sorted.to(torch.int64).clamp(0, feat9.shape[0] - 1)]


def _box_of_pixel(tile: int, box_w: int, box_h: int, device) -> torch.Tensor:
    """(P,) box number (box_mask_local's, row-major) of each tile pixel."""
    p = torch.arange(tile * tile, device=device)
    return (p // tile) // box_h * (tile // box_w) + (p % tile) // box_w


def _composite_tiles(feat, valid, px, py, cfg: RasterizerConfig, keep=None):
    """feat (B, L, 9) tile-local pair rows, valid (B, L); px/py (P,).
    keep (B, L, P) bool, if given, drops the evaluations it rejects. Returns
    (C (B, 3, P), T (B, P), evaluated (B, L, P) bool, accepted (B, L, P)
    bool)."""
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
    alpha = _ClampNoGate.apply(alpha_raw, cfg.alpha_clamp)
    passes = (alpha_raw >= torch.tensor(cfg.alpha_min, dtype=torch.float32)) \
        & valid[..., None]
    if keep is not None:
        passes = passes & keep
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
    return C, torch.exp(cum_acc[:, -1]), evaluated, accepted


class _Layout(NamedTuple):
    """Per-call constants of the batched per-tile gather."""
    L: int                 # pairs gathered per tile
    step: int              # tiles per batch
    px: torch.Tensor       # (P,) tile-local pixel x
    py: torch.Tensor       # (P,)
    ox: torch.Tensor       # (T,) tile origin x
    oy: torch.Tensor       # (T,)
    in_image: torch.Tensor  # (T, P) bool


def _layout(tile_counts, width, height, cfg, max_per_tile, row_offset=0,
            row_stride=1) -> _Layout:
    dev = tile_counts.device
    gx, gy = cfg.grid_size(width, height)
    T, P, t = gx * gy, cfg.pixels_per_tile, cfg.tile
    counts = tile_counts.to(torch.int64)
    L = max(1, min(max_per_tile, int(counts.max())))
    p = torch.arange(P, device=dev)
    tiles = torch.arange(T, device=dev)
    # Tile origins, so means become tile-local exactly as emission forms
    # them in the reference (mx - tx * tile in f32).
    return _Layout(
        L=L, step=max(1, BATCH_ELEMS // (L * P)),
        px=(p % t).to(torch.float32), py=(p // t).to(torch.float32),
        ox=((tiles % gx) * t).to(torch.float32),
        oy=((row_offset + (tiles // gx) * row_stride) * t).to(torch.float32),
        in_image=(((tiles % gx) * t)[:, None] + (p % t) < width)
        & (((tiles // gx) * t)[:, None] + (p // t) < height))


def _gather(lay: _Layout, sl: slice, tile_starts, tile_counts, K: int):
    """Sorted-slot index (B, L) of each tile's pairs and its valid mask."""
    ar = torch.arange(lay.L, device=tile_starts.device)
    idx = tile_starts[sl, None].to(torch.int64) + ar
    valid = ar < tile_counts[sl, None].to(torch.int64)
    return torch.where(valid & (idx < K), idx, K - 1), valid


def _tile_local(rows, lay: _Layout, sl: slice):
    """(B, L, 9) pair rows with means made tile-local."""
    return torch.cat([(rows[..., 0] - lay.ox[sl, None])[..., None],
                      (rows[..., 1] - lay.oy[sl, None])[..., None],
                      rows[..., 2:]], dim=-1)


def reach_extents_plain(ca, cb, cc, op):
    """Half-extents (hx, hy), in pixels about the mean, of the axis-aligned
    box around the ellipse inside which a gaussian can reach the alpha cut
    less the cull's 2% margin: q <= L = log(op / ALIVE_MIN) bounds dx^2 by
    2 L cc / det and dy^2 by 2 L ca / det. Widened by 1% and half a pixel;
    +inf for a conic that is not positive definite; -inf (no box meets it)
    where op is under the cut. The same arithmetic as
    ``csrc/composite.cu::reach_extents``."""
    f32 = torch.float32
    L = torch.log(op / torch.tensor(ALIVE_MIN, dtype=f32)) + 1e-3
    k = 2.0 * L / (ca * cc - cb * cb)
    inf = torch.tensor(float("inf"), dtype=f32)

    def extent(e):
        h = torch.where(e >= 0, 1.01 * torch.sqrt(e.clamp_min(0)) + 0.5, inf)
        return torch.where(L < 0, -inf, h)

    return extent(k * cc), extent(k * ca)


def box_mask_local(feat, tile: int, box_w: int = BOX_W,
                   box_h: int = BOX_H) -> torch.Tensor:
    """feat (..., 9) pair rows with TILE-LOCAL means -> (..., boxes) bool:
    whether the pair can reach the alpha cut (with the emission cull's 2%
    margin) in each box_w x box_h box of the tile, boxes numbered row-major.
    The emission cull's test (emit.box_alive_plain) over the box's pixel
    centres, asked only of the boxes that meet the pair's reach_extents
    box (which holds every box the test accepts); at one box per tile it is
    emission's own alive decision."""
    nbx = tile // box_w
    b = torch.arange(nbx * (tile // box_h), device=feat.device)
    x_lo = ((b % nbx) * box_w).to(torch.float32) - feat[..., 0, None]
    y_lo = ((b // nbx) * box_h).to(torch.float32) - feat[..., 1, None]
    x_hi, y_hi = x_lo + (box_w - 1), y_lo + (box_h - 1)
    conic_op = [feat[..., i, None] for i in (2, 3, 4, 5)]
    hx, hy = reach_extents_plain(*conic_op)
    return ((x_lo <= hx) & (x_hi >= -hx) & (y_lo <= hy) & (y_hi >= -hy)
            & box_alive_plain(*conic_op, x_lo, x_hi, y_lo, y_hi))


def pair_box_mask_plain(pair_feat, tile_starts, tile_counts, width: int,
                        height: int, cfg: RasterizerConfig,
                        box_w: int = BOX_W, box_h: int = BOX_H,
                        row_offset: int = 0, row_stride: int = 1):
    """Plain version of the sub-box mask kernel K3 computes as it stages a
    pair: pair_feat (K, 9) rows of the sorted slots with GLOBAL means ->
    (K,) int64, bit b set if the pair can land in box b of its tile
    (box_mask_local's numbering); 0 for slots outside every tile's range.
    Conservative: every pixel at which alpha_raw reaches 1/255 lies in a
    box whose bit is set."""
    gx, gy = cfg.grid_size(width, height)
    K, T = pair_feat.shape[0], gx * gy
    if (cfg.tile // box_w) * (cfg.tile // box_h) > 62:
        raise ValueError("more boxes per tile than bits in the mask")
    ends = (tile_starts + tile_counts).to(torch.int64)
    slot = torch.arange(K, dtype=torch.int64, device=pair_feat.device)
    t = torch.searchsorted(ends, slot, right=True)
    in_tile = t < T
    t = t.clamp(max=T - 1)
    ox = ((t % gx) * cfg.tile).to(torch.float32)
    oy = ((row_offset + (t // gx) * row_stride) * cfg.tile).to(torch.float32)
    local = torch.cat([(pair_feat[:, 0] - ox)[:, None],
                       (pair_feat[:, 1] - oy)[:, None], pair_feat[:, 2:]], 1)
    alive = box_mask_local(local.detach(), cfg.tile, box_w, box_h)
    bits = (alive.to(torch.int64)
            << torch.arange(alive.shape[1], device=alive.device)).sum(1)
    return torch.where(in_tile, bits, 0)


def _box_evaluations(evaluated, bits, tile: int, box_w: int, box_h: int):
    """(pair, pixel) evaluations when each pair of evaluated (B, L, P) is
    evaluated over whole boxes: the boxes its mask bits (B, L) keep and in
    which some pixel evaluates it."""
    B, L, _ = evaluated.shape
    nbx, nby = tile // box_w, tile // box_h
    any_px = evaluated.reshape(B, L, nby, box_h, nbx, box_w).any(5).any(3)
    kept = (bits[..., None] >> torch.arange(nbx * nby, device=bits.device)) & 1
    return (any_px.reshape(B, L, -1) & kept.bool()).sum() * (box_w * box_h)


def composite_plain(pair_feat, tile_starts, tile_counts, width: int,
                    height: int, cfg: RasterizerConfig,
                    max_per_tile: int = 4096, box_mask=None,
                    drop_culled: bool = False, row_offset: int = 0,
                    row_stride: int = 1) -> Composited:
    """pair_feat (K, 9) rows of the sorted slots with GLOBAL means; tile
    ranges (T,). Differentiable w.r.t. pair_feat. With box_mask (K,) int64
    from pair_box_mask_plain it also counts n_box_evaluated, and with
    drop_culled it drops, as kernel K2 does, every evaluation in a sub-box
    the mask rejects."""
    dev = pair_feat.device
    gx, gy = cfg.grid_size(width, height)
    T, P = gx * gy, cfg.pixels_per_tile
    lay = _layout(tile_counts, width, height, cfg, max_per_tile, row_offset,
                  row_stride)
    color, final_T, n_eval, n_acc = [], [], [], []
    n_box = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, T, lay.step):
        sl = slice(b0, min(T, b0 + lay.step))
        idx, valid = _gather(lay, sl, tile_starts, tile_counts,
                             pair_feat.shape[0])
        keep = None
        if drop_culled:
            keep = (box_mask[idx][..., None] >> _box_of_pixel(
                cfg.tile, BOX_W, BOX_H, dev) & 1).bool()
        C, Tf, evaluated, accepted = _composite_tiles(
            _tile_local(pair_feat[idx], lay, sl), valid, lay.px, lay.py, cfg,
            keep)
        color.append(C)
        final_T.append(Tf)
        n_eval.append((evaluated & lay.in_image[sl, None]).sum((1, 2)))
        n_acc.append((accepted & lay.in_image[sl, None]).sum((1, 2)))
        if box_mask is not None:
            n_box += _box_evaluations(evaluated & lay.in_image[sl, None],
                                      box_mask[idx], cfg.tile, BOX_W, BOX_H)

    color, final_T = assemble_image(torch.cat(color), torch.cat(final_T), gx,
                                    gy, width, height, cfg.tile)
    n_eval, n_acc = torch.cat(n_eval), torch.cat(n_acc)
    return Composited(color=color, final_T=final_T,
                      tile_overflow=torch.any(tile_counts > max_per_tile),
                      n_evaluated=n_eval.sum(), n_accepted=n_acc.sum(),
                      n_box_evaluated=n_box, tile_evaluated=n_eval,
                      tile_accepted=n_acc)


def composite_backward_plain(pair_feat, tile_starts, tile_counts, dcolor,
                             dfinal_T, width: int, height: int,
                             cfg: RasterizerConfig,
                             max_per_tile: int = 4096, row_offset: int = 0,
                             row_stride: int = 1) -> torch.Tensor:
    """Plain version of kernel K3: the gradient of composite_plain's
    (color, final_T) w.r.t. pair_feat, for cotangents dcolor (3, H, W) and
    dfinal_T (H, W). Returns (K, 9) per-pair gradients at SORTED positions
    (zero for slots that are not composited). Recomputes each tile batch's
    forward under autograd, so memory stays at one batch's intermediates."""
    gx, gy = cfg.grid_size(width, height)
    T = gx * gy
    K = pair_feat.shape[0]
    lay = _layout(tile_counts, width, height, cfg, max_per_tile, row_offset,
                  row_stride)
    dC, dT = split_image(dcolor, dfinal_T, gx, gy, cfg.tile)
    dpairs = torch.zeros((K, 9), dtype=torch.float32,
                         device=pair_feat.device)
    for b0 in range(0, T, lay.step):
        sl = slice(b0, min(T, b0 + lay.step))
        idx, valid = _gather(lay, sl, tile_starts, tile_counts, K)
        with torch.enable_grad():
            rows = pair_feat[idx].detach().requires_grad_(True)
            C, Tf, _, _ = _composite_tiles(_tile_local(rows, lay, sl), valid,
                                        lay.px, lay.py, cfg)
            (g,) = torch.autograd.grad((C, Tf), rows, (dC[sl], dT[sl]))
        # Each sorted slot lies in exactly one tile: a plain scatter.
        dpairs[idx[valid]] = g[valid]
    return dpairs


def assemble_image(color_tiles, final_T_tiles, gx: int, gy: int, width: int,
                   height: int, tile: int):
    """(T, 3, tile*tile) tile outputs -> (3, H, W) image + (H, W) final_T."""
    c = color_tiles.reshape(gy, gx, 3, tile, tile)
    c = c.permute(2, 0, 3, 1, 4).reshape(3, gy * tile, gx * tile)
    f = final_T_tiles.reshape(gy, gx, tile, tile)
    f = f.permute(0, 2, 1, 3).reshape(gy * tile, gx * tile)
    return c[:, :height, :width].contiguous(), f[:height, :width].contiguous()


def split_image(color, final_T, gx: int, gy: int, tile: int):
    """Inverse of assemble_image: (3, H, W) + (H, W) -> (T, 3, tile*tile) +
    (T, tile*tile), zero outside the image."""
    H, W = final_T.shape
    pad = (0, gx * tile - W, 0, gy * tile - H)
    c = torch.nn.functional.pad(color, pad).reshape(3, gy, tile, gx, tile)
    c = c.permute(1, 3, 0, 2, 4).reshape(gx * gy, 3, tile * tile)
    f = torch.nn.functional.pad(final_T, pad).reshape(gy, tile, gx, tile)
    f = f.permute(0, 2, 1, 3).reshape(gx * gy, tile * tile)
    return c, f
