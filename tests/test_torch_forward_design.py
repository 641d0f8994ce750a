"""Plain versions behind the designs of the compositing forward (kernel K2)
and the pair emission (kernel K1), on the CPU:

* dropping from ``composite_plain`` every evaluation K2 drops (the sub-boxes
  ``pair_box_mask_plain`` rejects) leaves colour and final_T bit-equal;
* the box around a pair's reach (``reach_extents_plain``), which K2 and K3
  use to pick the sub-boxes worth a box test, holds every sub-box the box
  test accepts;
* K1's warp expansion (a run of 32 gaussians -> its span of slots, swept 32
  at a time, each slot finding its gaussian by a five-step binary search
  over the run's offsets) gives ``emission_plain``'s keys and ids.

Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import (_depth_msbs, box_alive_plain,
                                               emission_plain, key_bits)
from gs2mesh_torch.ops.rasterizer.tile_render import (BOX_H, BOX_W,
                                                      composite_plain,
                                                      pair_box_mask_plain,
                                                      reach_extents_plain)
from tests.test_torch_backward_design import H, W, random_pairs
from tests.test_torch_kernels import EMISSION_CASES, emission_case

torch.set_num_threads(1)

def saturating_pairs(n=150, seed=4):
    """Tile-spanning splats of opacity ~0.1 over tile 0 of the 40x32 image:
    T falls under 1e-4 after some 90 pairs, inside the second 64-pair batch."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(4, 28, (n, 2))
    s = rng.uniform(30.0, 60.0, n)
    conic = np.stack([1 / s ** 2, np.zeros(n), 1 / s ** 2], 1)
    feat = np.concatenate([mean, conic, rng.uniform(0.08, 0.12, (n, 1)),
                           rng.uniform(0, 1, (n, 3))], 1).astype(np.float32)
    return torch.from_numpy(feat), np.zeros(n, np.int64)


@pytest.mark.parametrize("case", ["subpixel", "few_pixel", "tile_spanning",
                                  "opacity_at_cut", "saturates_mid_batch"])
def test_dropping_culled_evaluations_keeps_every_bit(case):
    """composite_plain with every (pair, sub-box) the plain mask rejects
    dropped: colour, final_T and the accepted count are unchanged, and
    evaluations were in fact dropped."""
    if case == "saturates_mid_batch":
        feat, tile = saturating_pairs()
    else:
        feat, tile = random_pairs(case)
    n0 = int((tile == 0).sum())
    starts = torch.tensor([0, n0], dtype=torch.int32)
    counts = torch.tensor([n0, feat.shape[0] - n0], dtype=torch.int32)
    cfg = RasterizerConfig()
    args = (feat, starts, counts, W, H, cfg)
    mask = pair_box_mask_plain(*args)
    full = composite_plain(*args, box_mask=mask)
    cut = composite_plain(*args, box_mask=mask, drop_culled=True)
    assert torch.equal(full.color, cut.color)
    assert torch.equal(full.final_T, cut.final_T)
    assert int(full.n_accepted) == int(cut.n_accepted)
    assert int(full.n_evaluated) == int(cut.n_evaluated) > 0
    if case == "saturates_mid_batch":
        # every pixel of tile 0 stops between pair 64 and the last one
        assert float(full.final_T[:, :32].max()) < 2e-4
        assert 64 * 1024 < int(full.n_evaluated) < (n0 - 10) * 1024
        assert int(full.n_accepted) > 64 * 1024
    elif case != "opacity_at_cut":
        assert int(full.n_accepted) > 0
    if case in ("subpixel", "few_pixel"):
        # most sub-boxes are masked out: far fewer box evaluations
        assert int(full.n_box_evaluated) < int(full.n_evaluated) // 4


@pytest.mark.parametrize("case", ["subpixel", "few_pixel", "tile_spanning",
                                  "opacity_at_cut"])
def test_reach_box_holds_every_alive_sub_box(case):
    """No sub-box that the box test accepts lies outside the pair's reach
    box; and for small splats the reach box leaves few sub-boxes to test."""
    feat, tile = random_pairs(case, n=480, seed=9)
    local = feat.clone()
    local[:, 0] -= 32.0 * torch.from_numpy(tile).float()
    b = torch.arange(32)
    x_lo = ((b % 4) * BOX_W).float() - local[:, 0, None]
    y_lo = ((b // 4) * BOX_H).float() - local[:, 1, None]
    x_hi, y_hi = x_lo + (BOX_W - 1), y_lo + (BOX_H - 1)
    conic_op = [local[:, i, None] for i in (2, 3, 4, 5)]
    alive = box_alive_plain(*conic_op, x_lo, x_hi, y_lo, y_hi)
    hx, hy = reach_extents_plain(*conic_op)
    meets = (x_lo <= hx) & (x_hi >= -hx) & (y_lo <= hy) & (y_hi >= -hy)
    assert not bool((alive & ~meets).any())
    assert int(alive.sum()) > 0
    if case in ("subpixel", "few_pixel"):
        assert float(meets.float().sum(1).mean()) < 8
    if case == "opacity_at_cut":
        low = feat[:, 5] < 0.975 / 255
        assert bool(low.any()) and not bool(meets[low].any())


def test_reach_extents_edge_cases():
    """A conic that is not positive definite meets every box; an opacity
    under the cut meets none; a unit conic at opacity 1 reaches
    sqrt(2 log(255 / 0.98)) pixels."""
    t = torch.tensor
    hx, hy = reach_extents_plain(t([1.0, 1.0, 1.0]), t([2.0, 0.0, 0.0]),
                                 t([1.0, 1.0, 1.0]), t([0.9, 0.003, 1.0]))
    assert hx[0] == hy[0] == float("inf")
    assert hx[1] == hy[1] == -float("inf")
    want = 1.01 * (2 * np.log(255 / 0.98)) ** 0.5 + 0.5
    assert abs(float(hx[2]) - want) < 1e-2 and hx[2] == hy[2]


def emission_by_warp_runs(feat9, depths, rect, tiles_touched, width, height,
                          cfg):
    """Keys and ids by kernel K1's decode: each run of 32 gaussians owns the
    slots from its first offset to its last gaussian's end (cut at the
    capacity); it sweeps them 32 at a time from the 32-slot boundary at or
    below the span's start; a slot's gaussian is the last of the run whose
    offset relative to the span (saturated to int32, INT_MAX beyond N) is
    not past it, found in five halving steps. Then emission_plain's cull and
    key. One vectorised pass per run."""
    K = cfg.pair_capacity
    N = tiles_touched.shape[0]
    gx, gy = cfg.grid_size(width, height)
    num_tiles, tb = gx * gy, key_bits(gx * gy)
    cum = torch.cumsum(tiles_touched.to(torch.int64), 0)
    offsets = cum - tiles_touched
    g_last = int(torch.searchsorted(cum, cum[-1] - 1, right=True))
    keys = torch.full((K,), (num_tiles << (32 - tb))
                      | int(_depth_msbs(depths[g_last:g_last + 1], tb)))
    ids = torch.full((K,), -1, dtype=torch.int32)
    written = torch.zeros(K, dtype=torch.int32)
    int_max = 2 ** 31 - 1
    for first in range(0, N, 32):
        in_run = min(32, N - first)
        off = offsets[first:first + in_run]
        start = int(off[0])
        end = min(int(off[-1] + tiles_touched[first + in_run - 1]), K)
        if end <= start:
            continue
        rel = torch.full((32,), int_max, dtype=torch.int64)
        rel[:in_run] = (off - start).clamp(max=int_max)
        s = torch.arange(start // 32 * 32, -(-end // 32) * 32)
        r = s - start
        j = torch.zeros_like(s)
        for b in (16, 8, 4, 2, 1):
            j = torch.where(rel[j + b] <= r, j + b, j)
        local = r - rel[j]
        live = (r >= 0) & (s < end)
        s, j, local = s[live], j[live], local[live]
        g = first + j
        rc = rect[g].to(torch.int64)
        rw = torch.clamp_min(rc[:, 2] - rc[:, 0], 1)
        tx, ty = rc[:, 0] + local % rw, rc[:, 1] + local // rw
        f = feat9[g]
        t = cfg.tile
        x_lo = tx.to(torch.float32) * t - f[:, 0]
        y_lo = ty.to(torch.float32) * t - f[:, 1]
        alive = box_alive_plain(f[:, 2], f[:, 3], f[:, 4], f[:, 5], x_lo,
                                x_lo + (t - 1), y_lo, y_lo + (t - 1))
        tile_id = torch.where(alive, ty * gx + tx, num_tiles)
        keys[s] = (tile_id << (32 - tb)) | _depth_msbs(depths[g], tb)
        ids[s] = g.to(torch.int32)
        written[s] += 1
    return keys, ids, written


@pytest.mark.parametrize("case", EMISSION_CASES)
def test_warp_expansion_matches_emission_plain(case):
    args = emission_case(case)
    cfg, touched = args[-1], args[3]
    ref = emission_plain(*args)
    keys, ids, written = emission_by_warp_runs(*args)
    assert torch.equal(keys, ref.keys)
    assert torch.equal(ids, ref.ids)
    n = min(int(ref.num_pairs), cfg.pair_capacity)
    # every emitted slot is written by exactly one run, no other slot is
    assert bool((written[:n] == 1).all()) and not bool(written[n:].any())
    num_tiles = 20 * 15
    culled = (ref.keys[:n] >> (32 - key_bits(num_tiles))) == num_tiles
    if case == "all_culled":
        assert bool(culled.all())
    else:
        assert not bool(culled.all())
    if case == "straddles_capacity":
        assert bool(ref.overflow) and n == cfg.pair_capacity
        off = ref.offsets
        assert bool(((off < n) & (off + touched > n)).any())
    if case == "wider_than_256":
        assert int(touched.max()) > 256
