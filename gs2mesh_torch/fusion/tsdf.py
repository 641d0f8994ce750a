"""Block-sparse TSDF volume on the device, in plain PyTorch.

Port of gs2mesh_tpu fusion/tsdf.py (the reference's Open3D
``ScalableTSDFVolume``, tsdf_utils.py:53-107): per-view projective SDF update
with nearest-pixel depth lookup, truncation ``sdf >= -sdf_trunc`` and a running
weighted average of TSDF and colour, over a fixed-capacity table of
``block_size``³-voxel blocks addressed by packed 30-bit block coordinates.

  * Voxel data sits at a stable slot for the life of the volume (append-only):
    fresh keys enter in ascending key order at slots ``n_blocks…``, and only
    ``order``, the stable argsort of ``keys``, is rebuilt.
  * ``allocate`` back-projects a strided pixel grid, samples the truncation
    band along each ray and merges the packed block keys into the table; it
    reads the count of fresh keys to the host, its one synchronisation.
  * ``integrate`` updates the live slots ``[:n_blocks]`` in place. JAX
    updates every slot and masks the free ones; slots are append-only, so the
    numbers are the same.

``n_blocks`` and ``overflow`` are host values: the caller needs both after
every allocation (the live slice, the grow-and-redo), and ``allocate`` has
them from its one read.

Arithmetic follows the JAX package op by op, as its eager CPU dispatch
evaluates it, so that the CPU tests hold the two to each other bit for bit:
divisions are true divisions by device tensors (CUDA turns a division by a
host scalar into a product with its reciprocal), the 3×3 products are
explicit multiply-adds (``_rows_times``) that no TF32 flag can change, and the
allocation offsets are ``jnp.linspace``'s values (``sample_offsets``).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gs2mesh_torch.fusion.marching import grid_origin

f32 = torch.float32
i32 = torch.int32

_COORD_BITS = 10
_COORD_OFF = 1 << (_COORD_BITS - 1)          # 512: block coords in [-512, 511]
_COORD_MASK = (1 << _COORD_BITS) - 1
EMPTY_KEY = 1 << 30                          # sorts after every packed key


class TSDFConfig(NamedTuple):
    """Static TSDF parameters."""

    voxel_size: float = 2.0 / 512            # reference default TSDF_voxel=2
    sdf_trunc: float = 0.04                  # tsdf_utils.py:55
    block_size: int = 8                      # voxels per block edge
    block_capacity: int = 1 << 13            # max allocated blocks
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    alloc_stride: int = 4                    # pixel stride for allocation

    @property
    def block_extent(self) -> float:
        return self.voxel_size * self.block_size


@dataclasses.dataclass
class TSDFVolume:
    """Fixed-capacity block-sparse volume: tensors on one device, and the
    two host values every view reads."""

    keys: torch.Tensor      # (C,) int32 packed block coords; EMPTY_KEY if free
    order: torch.Tensor     # (C,) int32 stable argsort of keys
    tsdf: torch.Tensor      # (C, bs**3) f32
    weight: torch.Tensor    # (C, bs**3) f32
    color: torch.Tensor     # (C, bs**3, 3) f32
    n_blocks: int           # live slots are [:n_blocks]
    overflow: bool          # block capacity exceeded (sticky)

    @property
    def device(self) -> torch.device:
        return self.keys.device


def create_volume(cfg: TSDFConfig, device="cuda") -> TSDFVolume:
    C, V = cfg.block_capacity, cfg.block_size ** 3
    return TSDFVolume(
        keys=torch.full((C,), EMPTY_KEY, dtype=i32, device=device),
        order=torch.arange(C, dtype=i32, device=device),
        tsdf=torch.zeros((C, V), dtype=f32, device=device),
        weight=torch.zeros((C, V), dtype=f32, device=device),
        color=torch.zeros((C, V, 3), dtype=f32, device=device),
        n_blocks=0, overflow=False)


def pack_keys(coords: torch.Tensor) -> torch.Tensor:
    """(…, 3) int block coords -> packed int32 key (EMPTY_KEY if out of
    range)."""
    c = coords.to(i32) + _COORD_OFF
    ok = ((c >= 0) & (c <= _COORD_MASK)).all(dim=-1)
    key = (c[..., 0] << (2 * _COORD_BITS)) | (c[..., 1] << _COORD_BITS) \
        | c[..., 2]
    return torch.where(ok, key, torch.full_like(key, EMPTY_KEY))


def unpack_keys(keys: np.ndarray) -> np.ndarray:
    """Packed int32 keys -> (…, 3) int32 block coords (host-side)."""
    k = np.asarray(keys, np.int64)
    x = (k >> (2 * _COORD_BITS)) & _COORD_MASK
    y = (k >> _COORD_BITS) & _COORD_MASK
    z = k & _COORD_MASK
    return np.stack([x, y, z], axis=-1).astype(np.int32) - _COORD_OFF


def unpack_keys_tensor(keys: torch.Tensor) -> torch.Tensor:
    """The tensor twin of ``unpack_keys``, on the keys' device."""
    x = (keys >> (2 * _COORD_BITS)) & _COORD_MASK
    y = (keys >> _COORD_BITS) & _COORD_MASK
    z = keys & _COORD_MASK
    return torch.stack([x, y, z], dim=-1) - _COORD_OFF


def _scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``: an operand that CUDA does not
    treat as a host scalar (a host-scalar divisor becomes a reciprocal
    product there). Filled on the device: a copy from the host would
    synchronise the stream."""
    return torch.full((), x, dtype=f32, device=device)


def _constant(values, device) -> torch.Tensor:
    """Host values as a float32 tensor on ``device``, copied without
    synchronising the stream (the host buffer is staged at once)."""
    return torch.as_tensor(np.asarray(values, np.float32)).to(
        device, non_blocking=True)


def _fma(a, b, c):
    """a * b + c for float32 tensors, rounded once to float32 (a fused
    multiply-add), from exact float64 parts: the product of two float32s is
    exact in float64, and TwoSum gives the float64 sum s and its rounding
    error e. s.float() is the answer unless s lies exactly halfway between
    two float32s (common when the operands have few significant bits, as
    grid coordinates do) and e is not zero: then the answer is the
    neighbour on e's side."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    f = s.float()
    d = s - f.double()
    g = torch.nextafter(f, torch.where(d > 0, torch.full_like(f, np.inf),
                                       torch.full_like(f, -np.inf)))
    tie = (d != 0) & ((f.double() + g.double()) * 0.5 == s) & (e != 0)
    return torch.where(tie & ((e > 0) == (d > 0)), g, f)


def _rows_times(p: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``p @ M`` for (…, 3) rows and a (3, 3) matrix, in the order XLA's CPU
    backend evaluates the JAX package's products (its vectorised dot loop):
    columns 0 and 1 as separately rounded products summed left to right,
    column 2 as a chain of fused multiply-adds. Explicit elementwise
    operations, so no TF32 setting reaches them and the CPU and the card
    agree bit for bit."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    cols = [x * M[0, k] + y * M[1, k] + z * M[2, k] for k in (0, 1)]
    cols.append(_fma(z, M[2, 2], _fma(y, M[1, 2], x * M[0, 2])))
    return torch.stack(cols, dim=-1)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the rational x, ties to even."""
    f = np.float32(float(x))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.float32(y).view(np.int32)) & 1))


def sample_offsets(cfg: TSDFConfig) -> np.ndarray:
    """The allocation's depth offsets, ``jnp.linspace(-trunc - bs_world,
    trunc + bs_world, n_samp)`` with JAX's float32 values: XLA compiles
    linspace's ``start * (1 - i/d) + stop * (i/d)`` to ``1/d`` as a constant,
    ``stop * (1/d)`` hoisted, and a fused multiply-add, on the second
    product except at i = 1 (where ``i * (stop/d)`` folds away). Checked bit
    for bit against jnp.linspace for 2-32 samples; ``torch.linspace``
    differs in the last bit, which moves ``floor`` across block edges."""
    bs_world = cfg.block_extent
    n = max(int(np.ceil(2.0 * cfg.sdf_trunc / bs_world)) + 1, 2) + 2
    start = np.float32(-cfg.sdf_trunc - bs_world)
    stop = np.float32(cfg.sdf_trunc + bs_world)
    div = n - 1
    r = np.float32(np.float32(1) / np.float32(div))
    stop_r = np.float32(stop * r)
    out = []
    for i in range(div):
        om = np.float32(np.float32(1) - np.float32(np.float32(i) * r))
        if i == 1:
            exact = Fraction(float(start)) * Fraction(float(om)) \
                + Fraction(float(stop_r))
        else:
            exact = Fraction(i) * Fraction(float(stop_r)) \
                + Fraction(float(np.float32(start * om)))
        out.append(_round_f32(exact))
    return np.array(out + [stop], np.float32)


def _local_offsets(bs: int, device) -> torch.Tensor:
    r = torch.arange(bs, dtype=f32, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)   # (bs**3, 3)


def integrate(vol: TSDFVolume, color: torch.Tensor, depth: torch.Tensor,
              K: torch.Tensor, extrinsic: torch.Tensor, depth_trunc: float,
              cfg: TSDFConfig) -> TSDFVolume:
    """Fuse one RGB-D view into the live slots, in place (returns ``vol``).
    Mirrors Open3D's projective TSDF update (tsdf_utils.py:106).

    color: (H, W, 3) float in [0, 1]; depth: (H, W) metric, 0 = invalid;
    K: (3, 3) pinhole intrinsics; extrinsic: (4, 4) world->camera; all on
    the volume's device.
    """
    n = vol.n_blocks
    if n == 0:
        return vol
    dev = vol.device
    bs = cfg.block_size
    H, W = depth.shape
    origin = _constant(cfg.origin, dev)

    coords = unpack_keys_tensor(vol.keys[:n])                 # (n, 3) int32
    base = coords.to(f32) * bs                                # voxel units
    pts = (base[:, None, :] + _local_offsets(bs, dev)[None] + 0.5) \
        * cfg.voxel_size + origin                             # (n, V, 3)

    R = extrinsic[:3, :3].to(f32)
    t = extrinsic[:3, 3].to(f32)
    cam = _rows_times(pts, R.T) + t                           # (n, V, 3)
    z = cam[..., 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # Open3D rounds to the nearest pixel (half to even, as jnp.round). The
    # bounds are tested in float: the same decision as JAX's saturating
    # int32 cast, without casting out-of-range floats.
    u = torch.round(fx * cam[..., 0] / z + cx)
    v = torch.round(fy * cam[..., 1] / z + cy)
    inb = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = (v.clamp(0, H - 1).to(torch.int64) * W
           + u.clamp(0, W - 1).to(torch.int64))
    d = depth.reshape(-1)[lin]
    rgb = color.reshape(-1, 3)[lin]

    valid = inb & (d > 0) & (d < _scalar(depth_trunc, dev))
    sdf = d - z
    trunc = _scalar(cfg.sdf_trunc, dev)
    valid = valid & (sdf >= -trunc)
    tsdf_obs = torch.clamp(sdf / trunc, max=1.0)

    w_old = vol.weight[:n]
    w_new = torch.where(valid, w_old + 1.0, w_old)
    denom = torch.clamp(w_new, min=1.0)
    tsdf_old = vol.tsdf[:n]
    vol.tsdf[:n] = torch.where(valid, (tsdf_old * w_old + tsdf_obs) / denom,
                               tsdf_old)
    color_old = vol.color[:n]
    vol.color[:n] = torch.where(
        valid[..., None],
        (color_old * w_old[..., None] + rgb) / denom[..., None], color_old)
    vol.weight[:n] = w_new
    return vol


def allocate(vol: TSDFVolume, depth: torch.Tensor, K: torch.Tensor,
             extrinsic: torch.Tensor, depth_trunc: float,
             cfg: TSDFConfig) -> TSDFVolume:
    """Allocate every block the view's truncation band touches. Returns a
    new volume with new ``keys`` / ``order`` that shares ``vol``'s voxel
    arrays (``vol`` itself is unchanged, so an overflowed view can be redone
    on it after ``grow_volume``).

    Back-projects an ``alloc_stride``-strided pixel grid to points at depths
    d + s for s across [-sdf_trunc, +sdf_trunc] plus a block each side,
    maps the points to block keys, and appends the fresh ones.
    """
    dev = vol.device
    H, W = depth.shape
    s = cfg.alloc_stride
    origin = _constant(cfg.origin, dev)

    rows = torch.arange(0, H, s, device=dev)
    cols = torch.arange(0, W, s, device=dev)
    vv, uu = torch.meshgrid(rows, cols, indexing="ij")
    d = depth[vv, uu]                                         # strided slice
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ray = torch.stack([(uu.to(f32) - cx) / fx, (vv.to(f32) - cy) / fy,
                       torch.ones_like(d)], dim=-1)           # (h, w, 3) cam
    offs = _constant(sample_offsets(cfg), dev)                # (S,)

    R = extrinsic[:3, :3].to(f32)
    t = extrinsic[:3, 3].to(f32)
    cam_pts = ray[None] * (d[None, ..., None] + offs[:, None, None, None])
    world = _rows_times(cam_pts - t, R)                       # (S, h, w, 3)
    block = torch.floor((world - origin) / _scalar(cfg.block_extent, dev))
    # Clamped before the cast (out-of-range blocks pack to EMPTY_KEY either
    # way); a NaN only arises where the depth is not finite, and those
    # samples are masked below.
    block = block.clamp(-(1 << 20), 1 << 20).to(i32)
    keys = pack_keys(block)
    ok = (d > 0) & (d < _scalar(depth_trunc, dev))
    keys = torch.where(ok[None].expand_as(keys), keys,
                       torch.full_like(keys, EMPTY_KEY))
    return _merge_keys(vol, keys.reshape(-1), cfg)


def _merge_keys(vol: TSDFVolume, cand: torch.Tensor,
                cfg: TSDFConfig) -> TSDFVolume:
    C = cfg.block_capacity
    cand = torch.sort(cand).values
    uniq = torch.ones_like(cand, dtype=torch.bool)
    uniq[1:] = cand[1:] != cand[:-1]
    uniq &= cand != EMPTY_KEY

    # Membership test against the sorted existing keys.
    keys_sorted = vol.keys[vol.order.long()]
    pos = torch.searchsorted(keys_sorted, cand)
    member = keys_sorted[pos.clamp(0, C - 1)] == cand
    fresh = uniq & ~member

    rank = torch.cumsum(fresh, dim=0) - 1                     # (M,)
    n_fresh = int(fresh.sum())                                # the one sync
    slot = vol.n_blocks + rank
    dest = torch.where(fresh & (slot < C), slot, torch.full_like(slot, C))
    new_keys = torch.cat([vol.keys, vol.keys.new_full((1,), EMPTY_KEY)])
    new_keys = new_keys.scatter(0, dest, cand)[:C]            # C = drop slot
    return dataclasses.replace(
        vol, keys=new_keys,
        order=torch.argsort(new_keys, stable=True).to(i32),
        n_blocks=min(vol.n_blocks + n_fresh, C),
        overflow=vol.overflow or vol.n_blocks + n_fresh > C)


def integrate_view(vol: TSDFVolume, color: torch.Tensor, depth: torch.Tensor,
                   K: torch.Tensor, extrinsic: torch.Tensor,
                   depth_trunc: float, cfg: TSDFConfig) -> TSDFVolume:
    """allocate + integrate (the per-view step of TSDF.run,
    tsdf_utils.py:59-107)."""
    vol = allocate(vol, depth, K, extrinsic, depth_trunc, cfg)
    return integrate(vol, color, depth, K, extrinsic, depth_trunc, cfg)


def grow_volume(vol: TSDFVolume, cfg: TSDFConfig,
                factor: int = 2) -> tuple[TSDFVolume, TSDFConfig]:
    """Capacity growth (the unbounded allocation of Open3D's
    ScalableTSDFVolume, tsdf_utils.py:53): keys and voxel data copied
    verbatim into a ``factor`` times larger table, overflow reset. Redo the
    allocation that overflowed on the grown volume; its voxel data must not
    have been integrated with that view yet."""
    new_c = cfg.block_capacity * factor
    pad = new_c - cfg.block_capacity

    def padded(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    keys = padded(vol.keys, EMPTY_KEY)
    grown = TSDFVolume(
        keys=keys, order=torch.argsort(keys, stable=True).to(i32),
        tsdf=padded(vol.tsdf), weight=padded(vol.weight),
        color=padded(vol.color), n_blocks=vol.n_blocks, overflow=False)
    return grown, cfg._replace(block_capacity=new_c)


def to_dense(vol: TSDFVolume, cfg: TSDFConfig):
    """Scatter the live blocks into dense grids over their bounding box, on
    the volume's device.

    Returns (tsdf, weight, color, grid_origin_world): (X, Y, Z[, 3]) tensors
    and a (3,) float32 numpy origin.
    """
    bs = cfg.block_size
    n = vol.n_blocks
    dev = vol.device
    if n == 0:
        z = torch.zeros((0, 0, 0), dtype=f32, device=dev)
        return (z, z, torch.zeros((0, 0, 0, 3), dtype=f32, device=dev),
                np.zeros(3, np.float32))
    coords = unpack_keys_tensor(vol.keys[:n]).long()          # (n, 3)
    lo = coords.min(dim=0).values
    nb = (coords.max(dim=0).values + 1 - lo).tolist()
    rel = coords - lo

    def scatter(data, tail):
        blocks = data.new_zeros(tuple(nb) + (bs, bs, bs) + tail)
        blocks[rel[:, 0], rel[:, 1], rel[:, 2]] = \
            data[:n].reshape((n, bs, bs, bs) + tail)
        perm = (0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(tail)))
        return blocks.permute(perm).reshape(tuple(b * bs for b in nb) + tail)

    return (scatter(vol.tsdf, ()), scatter(vol.weight, ()),
            scatter(vol.color, (3,)),
            grid_origin(cfg.origin, lo.cpu().numpy(), bs, cfg.voxel_size))
