"""Plain versions behind the compositing backward's design, on the CPU:

* ``pair_box_mask_plain`` (the sub-box mask kernel K3 computes as it stages
  a pair) is conservative, and at one box per tile it is the emission
  cull's own decision;
* ``segment_sum_slot_order`` (the float32 slot-order sum kernel K4 must
  equal bit for bit) is a sequential float32 sum, and agrees with
  ``segment_sum_plain`` and the JAX package's ``segment_sum_tpu``;
* ``composite_plain``'s count of the evaluations a sub-box compositor makes.

Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.ops.rasterizer.emit import FEAT, _reduce_sorted_cts
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emission_plain,
                                               key_bits, segment_sum_plain,
                                               segment_sum_slot_order,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.ops.rasterizer.tile_render import (BOX_H, BOX_W,
                                                      composite_plain,
                                                      pair_box_mask_plain,
                                                      pair_rows)
from tests import test_rasterizer as tr
from tests.test_torch_rasterizer import (CAM, CFG, NUM_TILES, scene_np,
                                         torch_args)

torch.set_num_threads(1)

W, H = 40, 32                       # two tiles, the second 8 pixels wide
CUT = np.float32(1.0 / 255.0)


def random_pairs(case, n=240, seed=0):
    """(n, 9) pair rows with global means around the two tiles of a 40x32
    image, and each pair's tile (the first half in tile 0)."""
    rng = np.random.default_rng(seed)
    sigma = {"subpixel": (0.15, 0.5), "few_pixel": (0.8, 3.0),
             "tile_spanning": (8.0, 40.0), "opacity_at_cut": (0.8, 6.0)}[case]
    tile = np.repeat([0, 1], n // 2)
    mean = np.stack([rng.uniform(-6, 38, n) + 32 * tile,
                     rng.uniform(-6, 38, n)], 1)
    s = rng.uniform(*sigma, size=(n, 2))
    th = rng.uniform(0, np.pi, n)
    c, sn = np.cos(th), np.sin(th)
    # covariance R diag(s^2) R^T and its inverse, the conic (a, b, c)
    cxx = c * c * s[:, 0] ** 2 + sn * sn * s[:, 1] ** 2
    cyy = sn * sn * s[:, 0] ** 2 + c * c * s[:, 1] ** 2
    cxy = c * sn * (s[:, 0] ** 2 - s[:, 1] ** 2)
    det = cxx * cyy - cxy ** 2
    conic = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    if case == "opacity_at_cut":
        op = rng.choice([1 / 255, 0.98 / 255, 0.97 / 255, 1.001 / 255,
                         1.02 / 255, 0.0045, 0.0039], n)
    else:
        op = rng.uniform(0.02, 1.0, n)
    feat = np.concatenate([mean, conic, op[:, None],
                           rng.uniform(0, 1, (n, 3))], 1).astype(np.float32)
    return torch.from_numpy(feat), tile


def alpha_raw_per_pixel(feat, tile):
    """(n, 32, 32) alpha_raw over each pair's tile, by the compositors'
    formula on tile-local means."""
    f = feat.numpy()
    mx = (f[:, 0] - np.float32(32) * tile.astype(np.float32))[:, None, None]
    my = f[:, 1][:, None, None]
    px = np.arange(32, dtype=np.float32)[None, None, :]
    py = np.arange(32, dtype=np.float32)[None, :, None]
    dx, dy = mx - px, my - py
    ca, cb, cc = (f[:, i][:, None, None] for i in (2, 3, 4))
    power = (np.float32(-0.5) * ca) * (dx * dx) \
        + dy * ((np.float32(-0.5) * cc) * dy - cb * dx)
    return f[:, 5][:, None, None] * np.exp(power)


@pytest.mark.parametrize("case", ["subpixel", "few_pixel", "tile_spanning",
                                  "opacity_at_cut"])
def test_box_mask_is_conservative(case):
    """Every pixel at which a pair's alpha_raw reaches 1/255 lies in an 8x4
    sub-box whose mask bit is set; and the mask does cull (small splats keep
    few of their 32 sub-boxes)."""
    feat, tile = random_pairs(case)
    n = feat.shape[0]
    starts = torch.tensor([0, n // 2], dtype=torch.int32)
    counts = torch.tensor([n // 2, n // 2], dtype=torch.int32)
    mask = pair_box_mask_plain(feat, starts, counts, W, H,
                               RasterizerConfig()).numpy()
    lands = alpha_raw_per_pixel(feat, tile) >= CUT              # (n, y, x)
    nbx = 32 // BOX_W
    box_lands = lands.reshape(n, 32 // BOX_H, BOX_H, nbx, BOX_W) \
        .any(axis=(2, 4)).reshape(n, -1)
    bits = (mask[:, None] >> np.arange(box_lands.shape[1])) & 1
    assert not (box_lands & (bits == 0)).any()
    kept = bits.sum(1)
    if case != "opacity_at_cut":
        assert lands.any(axis=(1, 2)).sum() > n // 4
    if case in ("subpixel", "few_pixel"):
        assert kept.mean() < 8
    if case == "tile_spanning":
        assert (kept == 32).sum() > n // 4
    if case == "opacity_at_cut":
        # an opacity below the margin lands nowhere and keeps no box
        low = feat[:, 5].numpy() < np.float32(0.975 / 255)
        assert low.any() and not kept[low].any()
        assert kept[~low].any()


def test_box_mask_at_tile_size_is_emission_alive():
    """With one box per tile the mask bit is emission_plain's alive
    decision, for every (gaussian, tile-of-its-rect) slot, kept or culled."""
    prep = preprocess(*torch_args(scene_np(256)), CAM, 0, CFG)
    feat9 = build_feat9(prep)
    em = emission_plain(feat9, prep.depths, prep.rect, prep.tiles_touched,
                        CAM.width, CAM.height, CFG)
    n = int(em.num_pairs)
    gx, _ = CFG.grid_size(CAM.width, CAM.height)
    tile_of_key = (em.keys[:n] >> (32 - key_bits(NUM_TILES))).numpy()
    alive = tile_of_key != NUM_TILES
    assert alive.any() and (~alive).any()
    # Each slot's own tile, from its gaussian's rect (row-major).
    g = em.ids[:n].to(torch.int64)
    r = prep.rect[g].numpy()
    local = (torch.arange(n) - em.offsets[g]).numpy()
    rw = np.maximum(r[:, 2] - r[:, 0], 1)
    tile = (r[:, 1] + local // rw) * gx + r[:, 0] + local % rw
    np.testing.assert_array_equal(tile[alive], tile_of_key[alive])
    by_tile = np.argsort(tile, kind="stable")
    counts = np.bincount(tile, minlength=NUM_TILES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    mask = pair_box_mask_plain(
        feat9[g][torch.from_numpy(by_tile)],
        torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(counts.astype(np.int32)), CAM.width, CAM.height,
        CFG, box_w=CFG.tile, box_h=CFG.tile).numpy()
    np.testing.assert_array_equal(mask == 1, alive[by_tile])
    assert set(np.unique(mask)) <= {0, 1}


def test_box_evaluations_lie_between_accepted_and_all_boxes():
    """composite_plain's n_box_evaluated with the real mask: at least the
    accepted evaluations (none is lost), at most what an all-ones mask
    gives, which in turn is at least the per-pixel count."""
    prep = preprocess(*torch_args(scene_np(256)), CAM, 0, CFG)
    feat9 = build_feat9(prep)
    pairs = sort_pairs(emission_plain(feat9, prep.depths, prep.rect,
                                      prep.tiles_touched, CAM.width,
                                      CAM.height, CFG), NUM_TILES)
    rows = pair_rows(feat9, pairs.ids)
    args = (rows, pairs.tile_starts, pairs.tile_counts, CAM.width,
            CAM.height, CFG)
    mask = pair_box_mask_plain(*args)
    assert not mask[int(pairs.tile_counts.sum()):].any()
    real = composite_plain(*args, box_mask=mask)
    full = composite_plain(*args, box_mask=torch.full_like(mask, 2 ** 32 - 1))
    none = composite_plain(*args)
    assert int(none.n_box_evaluated) == 0
    assert int(real.n_evaluated) == int(none.n_evaluated) > 0
    assert (int(real.n_accepted) <= int(real.n_box_evaluated)
            < int(full.n_box_evaluated))
    assert int(full.n_box_evaluated) >= int(real.n_evaluated)
    assert int(real.n_box_evaluated) % (BOX_W * BOX_H) == 0


def segments(case):
    """(dpairs (K, 9), offsets (N,), counts (N,)) for a K4 edge case."""
    rng = np.random.default_rng(3)
    if case == "empty_segments":
        counts = rng.integers(0, 6, size=256)
        counts[rng.random(256) < 0.5] = 0
        counts[[0, 255]] = 0
    elif case == "clipped_at_capacity":
        counts = rng.integers(1, 9, size=256)
    elif case == "long_segment":      # longer than K4's 512-row chunk
        counts = rng.integers(0, 4, size=256)
        counts[100] = 1500
    else:                             # "ragged_block": N not a multiple of 256
        counts = rng.integers(0, 12, size=300)
    counts = counts.astype(np.int32)
    total = int(counts.sum())
    chunk = tr.CFG.chunk
    K = (total - 37) // chunk * chunk if case == "clipped_at_capacity" \
        else -(-(total + 5) // chunk) * chunk
    dp = rng.normal(size=(K, 9)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return dp, offsets, counts


@pytest.mark.parametrize("case", ["empty_segments", "clipped_at_capacity",
                                  "long_segment", "ragged_block"])
def test_slot_order_sum(case):
    """segment_sum_slot_order is the sequential float32 sum of each segment
    (bit for bit), within float32 rounding of segment_sum_plain's float64
    sum, and agrees with the Pallas segment sum (interpret mode) fed the
    same rows with their gaussian ids."""
    dp, offsets, counts = segments(case)
    K, N = dp.shape[0], counts.shape[0]
    got = segment_sum_slot_order(torch.from_numpy(dp),
                                 torch.from_numpy(offsets),
                                 torch.from_numpy(counts)).numpy()
    seq = np.zeros((N, 9), np.float32)
    for g in range(N):
        for s in range(offsets[g], min(offsets[g] + counts[g], K)):
            seq[g] = seq[g] + dp[s]
    np.testing.assert_array_equal(got, seq)
    if case == "clipped_at_capacity":
        # one segment straddles the capacity, others lie wholly past it
        assert ((offsets < K) & (offsets + counts > K)).any()
        assert (offsets >= K).any()

    plain = segment_sum_plain(torch.from_numpy(dp), torch.from_numpy(offsets),
                              torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[counts == 0], 0.0)

    chunk = tr.CFG.chunk
    owner = np.repeat(np.arange(N), counts)
    ids = np.full(K, (1 << 22) - 1, np.int32)
    n_own = min(K, owner.shape[0])
    ids[:n_own] = owner[:n_own]
    ct = np.zeros((K, FEAT), np.float32)
    ct[:n_own, :9] = dp[:n_own]
    ct3d = ct.reshape(K // chunk, chunk, FEAT).transpose(0, 2, 1)
    ref = np.asarray(_reduce_sorted_cts(jnp.asarray(ct3d),
                                        jnp.asarray(ids.reshape(-1, chunk)),
                                        N, tr.CFG))[:, :9]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
