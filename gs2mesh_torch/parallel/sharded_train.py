"""Multi-rank GS training step: data parallelism over views x tile-row
sharded compositing (port of gs2mesh_tpu parallel/sharded_train.py).

One process per rank on a (data, gauss) DeviceMesh (``parallel/mesh.py``):

  * Gaussian rows are split over the ``gauss`` axis: rank g of the axis
    owns rows [g C/G, (g+1) C/G) of the parameters, the per-row state and
    the Adam moments, and runs the per-Gaussian preprocessing (projection,
    EWA, SH) on them only.
  * The compact splat features (feat9, and depth / rect / tile count) are
    all-gathered along ``gauss`` (``GatherRows``); the gradient of that
    gather sums every rank's cotangent over the axis (an all-reduce) and
    keeps the rank's own rows.
  * The hot path is tile-row sharded: rank g emits, sorts and composites
    only the pairs of its STRIDED set of tile rows, global row r belonging
    to rank r mod G (each rect's rows clipped to the local rows it owns).
    Kernels K1, K2 and K3 take the slice's (row_offset, row_stride) = (g,
    G), so the cull, the tile-local means and the pixel centres use the
    global y while keys and the image stay slice-local; each slice sizes its
    sort key for the whole image, so it orders its pairs exactly as the
    unsharded render does. K4 sums each slice's own pairs.
  * The loss is computed on the interleaved slices in place: L1 as a sum,
    SSIM with a per-tile-row 5-pixel halo exchange around the ring
    (``exchange_halos_strided``, point-to-point sends whose backward sends
    the cotangents the other way), so every 11x11 window sees the pixels
    the unsharded filter sees. Each rank differentiates its own partial
    loss (see ``sharded_gs_loss``).
  * Each ``data`` row renders a different view; gradients are all-reduced
    and averaged over ``data``, the densification statistics summed (max
    for the radii), so densify sees the totals single-device training sees.
  * A render that overflows ``pair_capacity`` (the per-slice capacity) on
    any rank takes no step on any rank; the host loop grows it and redoes
    the views.

The JAX package's step cache and retracing (``MAX_CACHED_STEPS``) exist
for ``jit`` and have no counterpart; K2 has no per-tile cap, so on the card
``tile_overflow`` is always false (the plain CPU compositor keeps its
bound).
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, List, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.models.gaussians import (FIELDS, GROUP_OF, STATE_FIELDS,
                                            GaussianModel, GaussianParams,
                                            GaussianState, activations)
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.composite import composite
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emit_pairs,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.ops.ssim import _band_matrix_np, gs_loss
from gs2mesh_torch.parallel.mesh import (all_gather_rows, mesh_coords,
                                         owned_rows)
from gs2mesh_torch.train.trainer import (TrainConfig, Trainer, grow_rows,
                                         optimizer_step_count,
                                         write_checkpoint, xyz_lr)

HALO = 5  # rows: 11x11 SSIM window half-width


class GatherRows(torch.autograd.Function):
    """(n, ...) rows of every rank of ``group`` -> (G n, ...) in rank order.
    Backward: the cotangent summed over the group, this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """GatherRows where the group has more than one rank, else x."""
    if dist.get_world_size(group) == 1:
        return x
    return GatherRows.apply(x, group)


class ShardedRender(NamedTuple):
    image_slice: torch.Tensor  # (3, rows_per*tile, W) this rank's rows
    row_valid: torch.Tensor    # (rows_per*tile, 1) 1.0 where global y < H
    radii: torch.Tensor        # (n_local,) shard-local visibility radii
    num_pairs: torch.Tensor    # () this slice's emission count
    overflow: torch.Tensor     # () this slice overflowed its capacity
    tile_overflow: torch.Tensor  # () a tile exceeded the plain per-tile cap


def slice_rows(height: int, cfg: RasterizerConfig, G: int):
    """(rows_per, h_slice): tile rows and pixel rows of each rank's slice."""
    gy = cfg.grid_size(1, height)[1]
    rows_per = -(-gy // G)
    return rows_per, rows_per * cfg.tile


def local_rects(rect, tiles_touched, rows_per: int, ax: int, G: int):
    """Each gaussian's global tile rect clipped to the strided rows rank ax
    owns, in local row indices: l in [ceil((y0 - ax) / G), floor((y1 - 1 -
    ax) / G)]. Returns (rect_loc (N, 4) int32, tiles_loc (N,) int32)."""
    y0l = torch.clamp(-((ax - rect[:, 1]) // G), 0, rows_per)
    y1l = torch.clamp((rect[:, 3] - 1 - ax) // G + 1, 0, rows_per)
    y1l = torch.maximum(y0l, y1l)
    rect_loc = torch.stack([rect[:, 0], y0l, rect[:, 2], y1l], dim=1)
    tiles_loc = torch.where(tiles_touched > 0,
                            (rect[:, 2] - rect[:, 0]) * (y1l - y0l), 0)
    return (rect_loc.to(torch.int32).contiguous(),
            tiles_loc.to(torch.int32).contiguous())


def row_valid_mask(h_slice: int, tile: int, ax: int, G: int, height: int,
                   device) -> torch.Tensor:
    """(h_slice, 1) 1.0 on the slice's pixel rows whose global row is inside
    the image: local pixel row l*tile + w is global row (ax + l*G)*tile + w."""
    r = torch.arange(h_slice, device=device)
    yglob = (ax + (r // tile) * G) * tile + r % tile
    return (yglob < height).to(torch.float32)[:, None]


def rasterize_sharded(params: GaussianParams, alive, camera: Camera,
                      sh_degree: int, bg, rcfg: RasterizerConfig, group,
                      screenspace_offset=None, max_per_tile: int = 4096,
                      scale_modifier: float = 1.0) -> ShardedRender:
    """Tile-row sharded render of the rank's rows ``params`` over the ranks
    of ``group`` (the gauss axis): local preprocess -> all-gather -> this
    slice's emission (K1) + sort + compositing (K2; K3 and K4 backward)."""
    G, ax = dist.get_world_size(group), dist.get_rank(group)
    inp = activations(params, alive)
    prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                      inp["opacities"], inp["shs"], camera, sh_degree, rcfg,
                      scale_modifier)
    if screenspace_offset is not None:
        prep = prep._replace(means2d=prep.means2d + screenspace_offset)
    feat9 = gather_rows(build_feat9(prep), group)
    # Depth bits, rect and tile count ride one int32 gather.
    aux = all_gather_rows(torch.cat([
        prep.depths.contiguous().view(torch.int32)[:, None], prep.rect,
        prep.tiles_touched[:, None]], dim=1), group)
    depths = aux[:, 0].contiguous().view(torch.float32)

    W, H = camera.width, camera.height
    gx, gy = rcfg.grid_size(W, H)
    rows_per, h_slice = slice_rows(H, rcfg, G)
    rect_loc, tiles_loc = local_rects(aux[:, 1:5], aux[:, 5], rows_per, ax, G)
    strided = dict(row_offset=ax, row_stride=G)
    with torch.no_grad():
        pairs = sort_pairs(emit_pairs(feat9.detach(), depths, rect_loc,
                                      tiles_loc, W, h_slice, rcfg,
                                      key_tiles=gx * gy, **strided),
                           gx * rows_per, key_tiles=gx * gy)
    color, final_T, tile_overflow = composite(
        feat9, pairs, tiles_loc, W, h_slice, rcfg, max_per_tile, **strided)
    image = color + final_T[None] * bg[:, None, None]
    # Zero rows past the true image height (the trailing global tile rows
    # are padding): keeps the loss exact and makes slice edges match the
    # unsharded SSIM filter's zero padding.
    row_valid = row_valid_mask(h_slice, rcfg.tile, ax, G, H, image.device)
    return ShardedRender(image_slice=image * row_valid[None],
                         row_valid=row_valid, radii=prep.radius,
                         num_pairs=pairs.num_pairs, overflow=pairs.overflow,
                         tile_overflow=tile_overflow)


def stitch_slices(slices: Sequence[torch.Tensor], height: int,
                  tile: int) -> torch.Tensor:
    """(C, h_slice, W) slices of ranks 0..G-1 -> the (C, height, W) image:
    local tile row l of slice g is global tile row g + l*G."""
    G = len(slices)
    C, h_slice, W = slices[0].shape
    R = h_slice // tile
    s = torch.stack([x.reshape(C, R, tile, W) for x in slices], dim=2)
    return s.reshape(C, R * G * tile, W)[:, :height]


def image_slice(img: torch.Tensor, G: int, ax: int, h_slice: int,
                tile: int) -> torch.Tensor:
    """Rank ax's (C, h_slice, W) slice of a full (C, H, W) image, zero on
    the rows past H (stitch_slices' inverse)."""
    C, H, W = img.shape
    R = h_slice // tile
    pad = torch.nn.functional.pad(img, (0, 0, 0, R * G * tile - H))
    return pad.reshape(C, R, G, tile, W)[:, :, ax].reshape(
        C, h_slice, W).contiguous()


class _RingExchange(torch.autograd.Function):
    """bottom goes to the next rank of the ring and top to the previous one;
    returns (from the previous rank's bottom, from the next rank's top).
    Backward sends the cotangents back the way they came."""

    @staticmethod
    def _swap(a, b, group, a_to_next: bool):
        peers = dist.get_process_group_ranks(group)
        G, ax = len(peers), dist.get_rank(group)
        nxt, prv = peers[(ax + 1) % G], peers[(ax - 1) % G]
        to_a, to_b = (nxt, prv) if a_to_next else (prv, nxt)
        ra, rb = torch.empty_like(a), torch.empty_like(b)
        ops = [dist.P2POp(dist.isend, a, to_a, group, tag=1),
               dist.P2POp(dist.irecv, ra, to_b, group, tag=1),
               dist.P2POp(dist.isend, b, to_b, group, tag=2),
               dist.P2POp(dist.irecv, rb, to_a, group, tag=2)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return ra, rb

    @staticmethod
    def forward(ctx, bottom, top, group):
        ctx.group = group
        return _RingExchange._swap(bottom.contiguous(), top.contiguous(),
                                   group, a_to_next=True)

    @staticmethod
    def backward(ctx, g_above, g_below):
        # g_above belongs to the previous rank's bottom, g_below to the next
        # rank's top: send each back, receive this rank's own.
        d_bottom_from_next, d_top_from_prev = _RingExchange._swap(
            g_above.contiguous(), g_below.contiguous(), ctx.group,
            a_to_next=False)
        return d_bottom_from_next, d_top_from_prev, None


def exchange_halos_strided(img4: torch.Tensor, ax: int, G: int, group):
    """Per-tile-row halos under strided row ownership.

    img4: (3, R, tile, W), this rank's tile rows (local row l is global tile
    row ax + l*G). Returns (3, R, tile + 2*HALO, W) with every tile row
    extended by the TRUE neighbouring pixel rows: the row above global row
    ax + l*G lives on rank (ax-1) mod G, at the same local index for ax > 0
    and at l-1 for ax == 0 (the ring wraps one local step down). One ring
    exchange each way; the image's top and bottom get zeros, as the
    unsharded filter's zero padding. Exact at G == 1 too, where the ring is
    the identity and the shifts stitch the rank's adjacent rows."""
    bottom = img4[:, :, -HALO:, :]
    top = img4[:, :, :HALO, :]
    if G == 1:
        recv_above, recv_below = bottom, top
    else:
        recv_above, recv_below = _RingExchange.apply(bottom, top, group)
    z = torch.zeros_like(recv_above[:, :1])
    above = torch.cat([z, recv_above[:, :-1]], 1) if ax == 0 else recv_above
    below = torch.cat([recv_below[:, 1:], z], 1) if ax == G - 1 \
        else recv_below
    return torch.cat([above, img4, below], dim=2)


@functools.lru_cache(maxsize=None)
def _valid_band_np(tile: int, window: int, sigma: float) -> np.ndarray:
    """(tile, tile + window - 1): row i holds the 1-D window's taps at
    columns i .. i + window - 1 (a VALID filter over halo rows)."""
    taps = _band_matrix_np(window, window, sigma)[window // 2]
    B = np.zeros((tile, tile + window - 1), np.float32)
    for i in range(tile):
        B[i, i:i + window] = taps
    return B


def _filter_rows(x4: torch.Tensor, Bv: torch.Tensor, Bh: torch.Tensor):
    """Separable filter over (3, R, h, W) tile-row stacks: vertical VALID
    (the halo rows supply the support), horizontal with zero 'same'
    padding; float32 matmuls as ops/ssim.py."""
    return torch.matmul(torch.matmul(Bv, x4), Bh.T)


def sharded_gs_loss(image_slice, row_valid, target, ax: int, height: int,
                    width: int, tile: int, lambda_dssim: float, G: int,
                    group):
    """Full-image (1-l)*L1 + l*(1-SSIM) from strided per-rank slices.

    target: the full (3, H, W) image (every rank holds it); image_slice:
    this rank's interleaved tile rows (local l = global ax + l*G), already
    zero past ``height``. The halo exchange gives every SSIM window the
    pixels the unsharded filter sees, so the slices' sum is ops.ssim.gs_loss
    on the stitched image.

    Returns (total, partial): ``total`` is the full-image loss (detached,
    summed over the group, for reporting); ``partial`` is this rank's share,
    summing to total - lambda_dssim over the group. DIFFERENTIATE
    ``partial``: the gather's backward already sums every rank's cotangents
    over the group, so grad(partial) is the full gradient, where grad of
    the summed total would arrive G-fold (invisible after Adam's
    per-coordinate rescaling, but it inflates the densification grad-norm
    statistics G-fold).

    At G == 1 the slice is the whole image (rows past ``height`` zero) and
    this is gs_loss itself, so a one-rank step is the single-device step."""
    if G == 1:
        loss = gs_loss(image_slice[:, :height], target, lambda_dssim)
        return loss.detach(), loss - lambda_dssim
    h_slice = image_slice.shape[1]
    R = h_slice // tile
    npix = 3.0 * height * width
    img4 = image_slice.reshape(3, R, tile, width)
    dev = image_slice.device

    # Target tile rows (with halo rows) taken from the full target: local
    # row l covers global pixel rows [(ax + l*G)*tile - HALO,
    # (ax + l*G + 1)*tile + HALO).
    tpad = torch.nn.functional.pad(
        target, (0, 0, HALO, HALO + G * h_slice - height))
    idx = ((ax + torch.arange(R, device=dev) * G) * tile)[:, None] \
        + torch.arange(tile + 2 * HALO, device=dev)[None, :]
    tgt_ext = tpad[:, idx]                       # (3, R, tile+2H, W)
    rv4 = row_valid.reshape(1, R, tile, 1)
    tgt4 = tgt_ext[:, :, HALO:-HALO, :] * rv4
    l1_part = torch.sum(torch.abs(img4 - tgt4))

    img_ext = exchange_halos_strided(img4, ax, G, group)
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    Bv = torch.from_numpy(_valid_band_np(tile, 11, 1.5)).to(dev)
    Bh = torch.from_numpy(_band_matrix_np(width, 11, 1.5)).to(dev)
    mu1 = _filter_rows(img_ext, Bv, Bh)
    mu2 = _filter_rows(tgt_ext, Bv, Bh)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter_rows(img_ext * img_ext, Bv, Bh) - mu1_sq
    s2 = _filter_rows(tgt_ext * tgt_ext, Bv, Bh) - mu2_sq
    s12 = _filter_rows(img_ext * tgt_ext, Bv, Bh) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    ssim_part = torch.sum(ssim_map * rv4)
    partial = ((1.0 - lambda_dssim) * l1_part
               - lambda_dssim * ssim_part) / npix
    total = partial.detach().clone()
    if G > 1:
        dist.all_reduce(total, group=group)
    return total + lambda_dssim, partial


class ShardedStepOutput(NamedTuple):
    loss: torch.Tensor               # () full-image loss, mean over data
    radii: torch.Tensor              # (n_local,) this rank's rows
    pairs_per_device: torch.Tensor   # (G,) emission count of each slice
    # The two bits demand different reactions (grow pair_capacity vs the
    # plain compositor's max_per_tile); an overflowed step took no update.
    overflow: bool
    tile_overflow: bool

    @property
    def num_pairs(self) -> torch.Tensor:
        return self.pairs_per_device


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: List[torch.Tensor]):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def sharded_train_step(model: GaussianModel, optimizer, mesh, camera: Camera,
                       target: torch.Tensor, bg: torch.Tensor,
                       cfg: TrainConfig, rcfg: RasterizerConfig,
                       sh_degree: int,
                       max_per_tile: int = 4096) -> ShardedStepOutput:
    """One step of this rank (``model`` holds its own rows, ``camera`` /
    ``target`` its data row's view): render its slice, differentiate its
    partial loss, average the gradients over ``data``, update its rows
    with Adam and add the view-summed densification statistics. Every rank
    of the mesh must call it together; a render that overflows on any rank
    takes no step anywhere."""
    gauss, data = mesh.get_group("gauss"), mesh.get_group("data")
    G, D = dist.get_world_size(gauss), dist.get_world_size(data)
    ax = dist.get_rank(gauss)
    params, state = model.params, model.state
    leaves = params.tensors()
    offs = torch.zeros((model.capacity, 2), dtype=torch.float32,
                       device=model.device, requires_grad=True)
    r = rasterize_sharded(params, state.alive, camera, sh_degree, bg, rcfg,
                          gauss, screenspace_offset=offs,
                          max_per_tile=max_per_tile)
    total, partial = sharded_gs_loss(
        r.image_slice, r.row_valid, target, ax, camera.height, camera.width,
        rcfg.tile, cfg.lambda_dssim, G, gauss)

    # One gather over the whole world: each rank's (num_pairs, overflow,
    # tile_overflow), laid out (data, gauss).
    info = all_gather_rows(torch.stack([
        r.num_pairs.to(torch.int64), r.overflow.to(torch.int64),
        r.tile_overflow.to(torch.int64)])[None], None).reshape(D, G, 3)
    pairs = info[..., 0].max(dim=0).values
    overflow, tile_overflow = (bool(v) for v in info[..., 1:].amax((0, 1)))
    if overflow or tile_overflow:
        return ShardedStepOutput(total, r.radii, pairs, overflow,
                                 tile_overflow)

    *grads, ss_grad = torch.autograd.grad(partial, leaves + [offs],
                                          allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    vis = r.radii > 0
    scale = torch.tensor([[0.5 * camera.width, 0.5 * camera.height]],
                         dtype=torch.float32, device=model.device)
    norm = torch.where(vis, torch.linalg.vector_norm(ss_grad * scale, dim=-1),
                       0.0)
    seen = torch.where(vis, 1.0, 0.0)
    radii = torch.where(vis, r.radii.to(torch.float32), 0.0)
    loss = total
    if D > 1:
        # Sum over the data axis: the gradients (then averaged), the
        # densification statistics and the loss (then averaged); the radii
        # by their maximum.
        summed = _flat(grads + [norm, seen, total[None]])
        dist.all_reduce(summed, group=data)
        *grads, norm, seen, loss = _unflat(
            summed, grads + [norm, seen, total[None]])
        grads = [g * (1.0 / D) for g in grads]
        loss = loss[0] * (1.0 / D)
        dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=data)

    model.state = GaussianState(
        alive=state.alive, xyz_grad_accum=state.xyz_grad_accum + norm,
        denom=state.denom + seen,
        max_radii2D=torch.maximum(state.max_radii2D, radii))
    # Dead padded rows can get NaN gradients (d/dq of the quaternion
    # normalization); zero them so dead rows and their moments stay at
    # their fill values.
    for leaf, g in zip(leaves, grads):
        leaf.grad = torch.where(
            state.alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
    optimizer.param_groups[0]["lr"] = xyz_lr(
        cfg, model.spatial_lr_scale, optimizer_step_count(optimizer))
    optimizer.step()
    for leaf in leaves:
        leaf.grad = None
    return ShardedStepOutput(loss, r.radii, pairs, False, False)


def _optimizer_shim(params: GaussianParams, moments: dict):
    """An object with an optimizer's ``param_groups`` / ``state`` over
    ``params`` (one named field a group), holding ``moments`` (group name
    -> Adam state dict), for densify_and_prune, grow_rows and
    write_checkpoint."""
    groups = [{"params": [getattr(params, f)], "name": GROUP_OF[f]}
              for f in FIELDS]
    return types.SimpleNamespace(
        param_groups=groups,
        state={g["params"][0]: moments[g["name"]] for g in groups
               if g["name"] in moments})


@dataclasses.dataclass
class ShardedTrainer(Trainer):
    """Multi-rank host training loop: ``Trainer``'s policy over a mesh.

    Every rank of ``mesh`` builds one with the same ``model`` (the whole
    model: every rank keeps only its own rows), cameras, images and seed,
    and the loop, the grow-and-redo on overflow (here of the per-slice
    ``pair_capacity``) and the density-control cadence are the
    single-device trainer's. Each step consumes ``data``-axis-many views
    (data-parallel gradient mean).

    Whatever needs the whole model (densify_and_prune, capacity growth,
    checkpoints) gathers the rows, the state and the Adam moments along
    ``gauss``; every rank runs it with the same seeded generator (so every
    rank computes the same rows) and keeps its own share. Capacity growth
    keeps the row count a multiple of the ``gauss`` axis. Checkpoints are
    the single-device trainer's chkpntN.pt and PLY, written by rank 0.
    The device is the model's (``device`` is not read).
    """

    mesh: Any = dataclasses.field(kw_only=True)

    log_tag = "sharded"

    def __post_init__(self):
        self.data_index, self.gauss_index = mesh_coords(self.mesh)
        if self.model.device.type != self.mesh.device_type:
            raise ValueError(f"model on {self.model.device}, mesh on "
                             f"{self.mesh.device_type}")
        self.device = self.model.device
        self.views_per_step = self.data_size
        if self.model.state is None:
            self.model.alive = torch.ones(self.model.capacity,
                                          dtype=torch.bool,
                                          device=self.device)
        G = self.gauss_size
        params, state = self.model.params, self.model.state
        if self.model.capacity % G:
            params, state = grow_rows(params, state, None,
                                      -(-self.model.capacity // G) * G)
        params, state, _ = self._own_rows(params, state)
        self.model = dataclasses.replace(self.model, params=params,
                                         state=state)
        super().__post_init__()

    @property
    def data_size(self) -> int:
        return self.mesh.size(0)

    @property
    def gauss_size(self) -> int:
        return self.mesh.size(1)

    @property
    def capacity(self) -> int:
        """Rows of the whole model."""
        return self.model.capacity * self.gauss_size

    def num_alive(self) -> int:
        n = self.model.state.alive.sum().reshape(1).to(torch.float32)
        if self.gauss_size > 1:
            dist.all_reduce(n, group=self.mesh.get_group("gauss"))
        return int(n)

    def _step(self, views, sh_degree: int):
        v = views[self.data_index]
        return sharded_train_step(
            self.model, self.optimizer, self.mesh, self.cameras[v],
            self._image_dev(v), self._bg(), self.cfg, self.rcfg, sh_degree,
            self.max_per_tile)

    # ------------------------------------------------------------------
    # The whole model, gathered along gauss
    # ------------------------------------------------------------------
    def _gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Row tensors of this rank -> the whole model's, in one gather
        (everything packed as float32 columns; booleans round-trip)."""
        n = self.model.capacity
        cols = [t.detach().reshape(n, -1).to(torch.float32) for t in tensors]
        full = all_gather_rows(torch.cat(cols, dim=1),
                               self.mesh.get_group("gauss"))
        out, i = [], 0
        for t, c in zip(tensors, cols):
            part = full[:, i:i + c.shape[1]]
            i += c.shape[1]
            part = part.reshape((full.shape[0],) + tuple(t.shape[1:]))
            out.append(part > 0.5 if t.dtype == torch.bool
                       else part.to(t.dtype).contiguous())
        return out

    def gather_model(self):
        """(GaussianModel of the whole model, Adam moments by group name)
        on every rank."""
        params = self.model.params.tensors()
        state = [getattr(self.model.state, k) for k in STATE_FIELDS]
        groups = [(g["name"], self.optimizer.state.get(g["params"][0], {}))
                  for g in self.optimizer.param_groups]
        mkeys = [(name, k) for name, st in groups
                 for k in ("exp_avg", "exp_avg_sq") if k in st]
        full = self._gather(params + state + [
            dict(groups)[name][k] for name, k in mkeys])
        p_full = GaussianParams(*full[:len(FIELDS)])
        s_full = GaussianState(**dict(zip(
            STATE_FIELDS, full[len(FIELDS):len(FIELDS) + len(STATE_FIELDS)])))
        moments = {name: {"step": st["step"]} for name, st in groups if st}
        for (name, k), m in zip(mkeys, full[len(FIELDS) + len(STATE_FIELDS):]):
            moments[name][k] = m
        model = dataclasses.replace(self.model, params=p_full, state=s_full)
        return model, moments

    def _whole(self):
        model, moments = self.gather_model()
        return model, _optimizer_shim(model.params, moments)

    def _set_whole(self, params: GaussianParams, state: GaussianState,
                   optimizer) -> None:
        """Keep this rank's rows of the whole model and of the moments
        ``optimizer`` (a shim over the gathered ones) holds."""
        params, self.model.state, rows = self._own_rows(params, state)
        for leaf, new in zip(self.model.params.tensors(), params.tensors()):
            leaf.data = new
        self._set_moments({g["name"]: optimizer.state[g["params"][0]]
                           for g in optimizer.param_groups
                           if g["params"][0] in optimizer.state}, rows)

    def _load_whole(self, model: GaussianModel, moments: dict) -> None:
        params, state, rows = self._own_rows(model.params, model.state)
        self.model = dataclasses.replace(model, params=params, state=state)
        self._new_optimizer()
        self._set_moments(moments, rows)

    def _own_rows(self, params: GaussianParams, state: GaussianState):
        """(params, state, rows): this rank's rows of the whole model's
        params and state, copied, and the slice of them."""
        rows = owned_rows(params.xyz.shape[0], self.gauss_size,
                          self.gauss_index)
        return (GaussianParams(*[t.detach()[rows].clone()
                                 for t in params.tensors()]),
                GaussianState(**{k: getattr(state, k)[rows].clone()
                                 for k in STATE_FIELDS}), rows)

    def grow_capacity(self, new_capacity: int):
        """Rounded up to a multiple of the gauss axis."""
        G = self.gauss_size
        super().grow_capacity(-(-new_capacity // G) * G)

    def save_checkpoint(self, path_dir: str):
        """Every rank gathers; rank 0 writes the PLY and chkpntN.pt; all
        return once the files exist."""
        model, optimizer = self._whole()
        if dist.get_rank() == 0:
            write_checkpoint(path_dir, model, optimizer, self.iteration,
                             **self._checkpoint_bounds())
        dist.barrier()
