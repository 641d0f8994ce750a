"""Multi-rank inference parallelism: view-parallel stereo + block-sharded
TSDF fusion (port of gs2mesh_tpu parallel/inference.py).

The stereo stage's per-view DLNR passes are pure data parallelism over the
``data`` mesh axis: each rank runs its share of the views and the outputs
are all-gathered. The TSDF volume's block table shards its voxel payload
across ranks: the keys stay replicated (a small int32 table, so the
host-driven allocation of ``fusion/tsdf.py`` runs identically on every
rank, and append-only slots mean a rank's voxel rows never move), and each
rank integrates the live blocks of its own rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gs2mesh_torch.fusion.tsdf import TSDFConfig, TSDFVolume, integrate
from gs2mesh_torch.parallel.mesh import all_gather_rows
from gs2mesh_torch.stereo import DLNRConfig, dlnr_forward


def make_sharded_dlnr(mesh, cfg: DLNRConfig = DLNRConfig(),
                      axis: str = "data"):
    """Returns f(model, images1, images2[, flow_init]) -> (flow_low,
    disp_full) for the whole batch, on every rank. The batch (view)
    dimension is split over ``axis`` (B a multiple of its size), each rank
    runs its views through ``dlnr_forward`` and the outputs are
    all-gathered; the model's weights are broadcast from the axis's first
    rank, so every rank computes with the same ones.

    images*: (B, 3, H, W) on this rank's device."""
    group = mesh.get_group(axis)
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(
        axis)
    src = dist.get_process_group_ranks(group)[0]

    @torch.no_grad()
    def run(model, images1, images2, flow_init=None):
        B = images1.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by the {axis} axis "
                             f"({n})")
        if n > 1:
            for t in model.state_dict().values():
                dist.broadcast(t, src=src, group=group)
        sl = slice(r * (B // n), (r + 1) * (B // n))
        out = dlnr_forward(model, images1[sl], images2[sl], cfg,
                           flow_init=None if flow_init is None
                           else flow_init[sl])
        return tuple(all_gather_rows(o, group) for o in out)

    return run


@dataclasses.dataclass
class VolumeShard(TSDFVolume):
    """One rank's share of a TSDFVolume: the full keys / order / n_blocks /
    overflow, and the voxel rows [row0, row0 + len(tsdf)) of the table."""

    row0: int = 0


def shard_volume(vol: TSDFVolume, mesh, axis: str = "data") -> VolumeShard:
    """This rank's share of ``vol`` (block capacity a multiple of the axis
    size): the voxel payload rows it owns, copied."""
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(
        axis)
    C = vol.keys.shape[0]
    if C % n:
        raise ValueError(f"block capacity {C} not divisible by the {axis} "
                         f"axis ({n})")
    c = C // n
    rows = slice(r * c, (r + 1) * c)
    return VolumeShard(keys=vol.keys, order=vol.order,
                       tsdf=vol.tsdf[rows].clone(),
                       weight=vol.weight[rows].clone(),
                       color=vol.color[rows].clone(), n_blocks=vol.n_blocks,
                       overflow=vol.overflow, row0=r * c)


def gather_volume(shard: VolumeShard, mesh, axis: str = "data") -> TSDFVolume:
    """The whole volume from every rank's shard (on every rank)."""
    group = mesh.get_group(axis)
    return TSDFVolume(keys=shard.keys, order=shard.order,
                      tsdf=all_gather_rows(shard.tsdf, group),
                      weight=all_gather_rows(shard.weight, group),
                      color=all_gather_rows(shard.color, group),
                      n_blocks=shard.n_blocks, overflow=shard.overflow)


def make_sharded_integrate(cfg: TSDFConfig):
    """Per-view TSDF integrate over a VolumeShard: each rank fuses the live
    blocks of its own voxel rows, in place (returns the shard; the shard
    carries its rows, so no collective is needed). The image / depth are
    replicated (every rank reads the pixels its blocks project to).
    Allocation stays host-driven exactly as in the single-device path:
    ``fusion.tsdf.allocate`` on the shard (it reads and writes only the
    replicated keys)."""

    def step(shard: VolumeShard, color, depth, K, extrinsic, depth_trunc):
        c = shard.tsdf.shape[0]
        keys = shard.keys[shard.row0:shard.row0 + c]
        local = TSDFVolume(keys=keys, order=shard.order, tsdf=shard.tsdf,
                           weight=shard.weight, color=shard.color,
                           n_blocks=min(max(shard.n_blocks - shard.row0, 0),
                                        c),
                           overflow=shard.overflow)
        integrate(local, color, depth, K, extrinsic, depth_trunc, cfg)
        return shard

    return step
