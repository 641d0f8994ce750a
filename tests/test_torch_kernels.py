"""CUDA kernels K1 (emission), K2 (compositing), K3 (compositing backward)
and K4 (per-gaussian sum) against their plain PyTorch versions on the card.
Marked ``cuda``; each test skips without a CUDA device. This file imports neither JAX nor the test scenes (which do),
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from gs2mesh_torch.core.camera import make_camera
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.composite import (composite_backward_cuda,
                                                    composite_cuda)
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emission_cuda,
                                               emission_plain,
                                               segment_sum_cuda,
                                               segment_sum_plain,
                                               segment_sum_slot_order,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.ops.rasterizer.tile_render import (composite_backward_plain,
                                                      composite_plain,
                                                      pair_box_mask_plain,
                                                      pair_rows)

pytestmark = pytest.mark.cuda
W, H = 200, 136                       # ragged last tile row and column


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same "
                    "kernel-vs-plain checks on the card")


def make_scene(n, sigma, seed=0):
    """(feat9, prep, cfg) of n gaussians on the unit sphere with world-space
    sigmas around ``sigma``, seen from z = -3 at W x H."""
    need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scales = np.abs(rng.normal(sigma, 0.3 * sigma, size=(n, 3))) + 1e-3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shs = rng.normal(scale=0.3, size=(n, 16, 3))
    args = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in
            (v, scales, q, rng.uniform(0.3, 0.95, n), shs)]
    eye = np.array([0.0, 0.0, -3.0])
    R = np.eye(3)
    cam = make_camera(R.T, -R @ eye, math.radians(60), math.radians(45), W,
                      H, device=dev)
    cfg = RasterizerConfig(pair_capacity=1 << 16)
    with torch.no_grad():
        prep = preprocess(*args, cam, 3, cfg)
    return build_feat9(prep), prep, cfg


@pytest.fixture(scope="module")
def scene():
    return make_scene(3000, 0.05)


@pytest.mark.parametrize("capacity", [1 << 16, 512])
def test_emission_kernel_matches_plain(scene, capacity):
    feat9, prep, cfg = scene
    cfg = RasterizerConfig(pair_capacity=capacity)
    a = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
    k, p = emission_cuda(*a), emission_plain(*a)
    torch.cuda.synchronize()
    assert int(k.num_pairs) == int(p.num_pairs)
    assert bool(k.overflow) == bool(p.overflow) == (capacity == 512)
    assert torch.equal(k.keys, p.keys) and torch.equal(k.ids, p.ids)


def emission_case(case):
    """(feat9, depths, rect, tiles_touched, W, H, cfg) on a 20x15 tile grid,
    CPU tensors: gaussians with no tiles (at run edges, a whole run of them),
    a splat of more tiles than a warp has lanes and one of more than 256, N
    not a multiple of a run's 32, a run whose span crosses the capacity, and
    every pair culled."""
    rng = np.random.default_rng(11)
    width, height = 640, 480
    gx, gy = 20, 15
    N = {"ragged_n": 77, "wider_than_256": 40}.get(case, 96)
    x0 = rng.integers(0, gx - 1, N)
    y0 = rng.integers(0, gy - 1, N)
    w = np.minimum(rng.integers(1, 4, N), gx - x0)
    h = np.minimum(rng.integers(1, 4, N), gy - y0)
    if case == "zero_tile_gaussians":
        dead = rng.random(N) < 0.5
        dead[[0, 1, 31, 32, 33, N - 1]] = True      # run edges and a run start
        dead[40:75] = True                          # a whole run's worth
        w[dead] = 0
    elif case == "wider_than_32":
        x0[5], y0[5], w[5], h[5] = 2, 3, 9, 5       # 45 tiles
    elif case == "wider_than_256":
        x0[33], y0[33], w[33], h[33] = 1, 0, 18, 15  # 270 tiles
    rect = np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.int32)
    touched = (w * h).astype(np.int32)
    touched[w == 0] = 0
    mean = np.stack([(x0 + w / 2) * 32, (y0 + h / 2) * 32], 1) \
        + rng.uniform(-8, 8, (N, 2))
    sigma = rng.uniform(6.0, 30.0, N) * np.maximum(w, 1)
    op = rng.uniform(0.05, 1.0, N)
    if case == "all_culled":
        op = np.full(N, 0.9 / 255)
    feat9 = np.concatenate([mean, np.stack([1 / sigma ** 2, np.zeros(N),
                                            1 / sigma ** 2], 1), op[:, None],
                            rng.uniform(0, 1, (N, 3))], 1).astype(np.float32)
    total = int(touched.sum())
    K = total - 19 if case == "straddles_capacity" else total + 45
    return (torch.from_numpy(feat9),
            torch.from_numpy(rng.uniform(1, 9, N).astype(np.float32)),
            torch.from_numpy(rect), torch.from_numpy(touched), width, height,
            RasterizerConfig(pair_capacity=K))


EMISSION_CASES = ["zero_tile_gaussians", "wider_than_32", "wider_than_256",
                  "ragged_n", "straddles_capacity", "all_culled"]



@pytest.mark.parametrize("case", EMISSION_CASES)
def test_emission_kernel_edge_cases(case):
    """K1's warp expansion bit for bit against emission_plain."""
    need_cuda()
    *tensors, width, height, cfg = emission_case(case)
    a = (*(t.cuda() for t in tensors), width, height, cfg)
    k, p = emission_cuda(*a), emission_plain(*a)
    torch.cuda.synchronize()
    assert int(k.num_pairs) == int(p.num_pairs)
    assert bool(k.overflow) == bool(p.overflow) == (
        case == "straddles_capacity")
    assert torch.equal(k.keys, p.keys) and torch.equal(k.ids, p.ids)
    assert torch.equal(k.offsets, p.offsets)


def test_composite_kernel_matches_plain(scene):
    feat9, prep, cfg = scene
    gx, gy = cfg.grid_size(W, H)
    pairs = sort_pairs(emission_cuda(feat9, prep.depths, prep.rect,
                                     prep.tiles_touched, W, H, cfg), gx * gy)
    a = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H, cfg)
    color, T = composite_cuda(*a)
    ref = composite_plain(pair_rows(feat9, pairs.ids), pairs.tile_starts,
                          pairs.tile_counts, W, H, cfg,
                          max_per_tile=int(pairs.tile_counts.max()))
    torch.cuda.synchronize()
    d = torch.cat([(color - ref.color).abs().flatten(),
                   (T - ref.final_T).abs().flatten()])
    assert float((d > 2e-5).float().mean()) <= 1e-4
    assert float(d.max()) <= 4e-3


FORWARD_SCENES = {"wide": (3000, 0.05, 0), "narrow": (20_000, 0.008, 2),
                  "sparse": (60, 0.03, 3)}


@pytest.mark.parametrize("name", list(FORWARD_SCENES))
def test_composite_kernel_design_cases(name):
    """K2 on the ragged 200x136 image (last tile row and column cut): wide
    splats (tiles of several 64-pair batches with a ragged last one), splats
    a few pixels wide (the sub-box mask drops most evaluations), and a
    sparse scene with empty tiles. Two runs give the same bits; the plain
    compositor agrees within K2's limits, whether or not it drops the
    evaluations K2 drops."""
    n, sigma, seed = FORWARD_SCENES[name]
    feat9, prep, cfg = make_scene(n, sigma, seed=seed)
    gx, gy = cfg.grid_size(W, H)
    pairs = sort_pairs(emission_cuda(feat9, prep.depths, prep.rect,
                                     prep.tiles_touched, W, H, cfg), gx * gy)
    assert not bool(pairs.overflow)
    counts = pairs.tile_counts
    if name == "wide":
        assert int(counts.max()) > 3 * 64 and bool((counts % 64 != 0).any())
    if name == "sparse":
        assert bool((counts == 0).any()) and bool((counts > 0).any())
    a = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H, cfg)
    color, T = composite_cuda(*a)
    color2, T2 = composite_cuda(*a)
    torch.cuda.synchronize()
    assert torch.equal(color, color2) and torch.equal(T, T2)
    rows = pair_rows(feat9, pairs.ids)
    mpt = max(int(counts.max()), 1)
    mask = pair_box_mask_plain(rows, pairs.tile_starts, counts, W, H, cfg)
    for drop in (False, True):
        ref = composite_plain(rows, pairs.tile_starts, counts, W, H, cfg,
                              max_per_tile=mpt, box_mask=mask,
                              drop_culled=drop)
        d = torch.cat([(color - ref.color).abs().flatten(),
                       (T - ref.final_T).abs().flatten()])
        assert float((d > 2e-5).float().mean()) <= 1e-4
        assert float(d.max()) <= 4e-3
    assert float(T.min()) < 0.9 and bool(torch.isfinite(color).all())


def check_backward_kernels(feat9, prep, cfg):
    """K3 per-pair gradients against the plain autograd on the live pair
    rows (nonzero in either) of the emitted slots (K3 leaves the rows past
    them unwritten): >= 99.9% of values within 1e-4 of each column's
    largest value plus 1e-3 relative (the kernel sums each pair's pixels in
    another order) and none more than 1e-3 of the column's largest value
    apart (a 1/255 or T-stop knife edge moves one pixel's share); K4
    against the plain sum of the same K3 rows and, bit for bit, against the
    float32 slot-order sum; both bit-identical across two runs. Returns the
    sorted pairs."""
    gx, gy = cfg.grid_size(W, H)
    pairs = sort_pairs(emission_cuda(feat9, prep.depths, prep.rect,
                                     prep.tiles_touched, W, H, cfg), gx * gy)
    assert not bool(pairs.overflow)
    a = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H, cfg)
    color, T = composite_cuda(*a)
    g = torch.Generator(device="cuda").manual_seed(0)
    dC = torch.randn((3, H, W), generator=g, device="cuda")
    dT = torch.randn((H, W), generator=g, device="cuda")
    k3 = [composite_backward_cuda(pairs.ids, pairs.order, pairs.tile_starts,
                                  pairs.tile_counts, pairs.num_pairs, feat9,
                                  color, T, dC, dT, W, H, cfg)
          for _ in range(2)]
    plain = torch.zeros_like(k3[0])
    plain[pairs.order] = composite_backward_plain(
        pair_rows(feat9, pairs.ids), pairs.tile_starts, pairs.tile_counts,
        dC, dT, W, H, cfg, max_per_tile=int(pairs.tile_counts.max()))
    torch.cuda.synchronize()
    n = int(pairs.num_pairs)
    assert not plain[n:].ne(0).any()
    assert torch.equal(k3[0][:n], k3[1][:n])
    got, plain = k3[0][:n], plain[:n]
    live = plain.ne(0).any(1) | got.ne(0).any(1)
    assert int(live.sum()) > 0
    scale = plain.abs().amax(0)
    gap = (got[live] - plain[live]).abs()
    assert float((gap > 1e-3 * plain[live].abs() + 1e-4 * scale)
                 .float().mean()) <= 1e-3
    assert float((gap / scale.clamp_min(1e-30)).max()) <= 1e-3
    k4 = [segment_sum_cuda(k3[0], pairs.offsets, prep.tiles_touched)
          for _ in range(2)]
    ref = segment_sum_plain(k3[0], pairs.offsets, prep.tiles_touched)
    torch.cuda.synchronize()
    assert torch.equal(k4[0], k4[1])
    torch.testing.assert_close(k4[0], ref, rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))
    assert torch.equal(k4[0], segment_sum_slot_order(
        k3[0], pairs.offsets, prep.tiles_touched))
    return pairs


def test_backward_kernels_match_plain(scene):
    """K3 and K4 on the 3000-gaussian scene of wide splats (see
    check_backward_kernels for the tolerances)."""
    check_backward_kernels(*scene)


def test_backward_kernels_narrow_splats():
    """Splats a few pixels wide on the ragged 200x136 image: K3's sub-box
    mask culls most (pair, warp) work and many pairs are accepted by no
    warp (their rows come from the fill)."""
    check_backward_kernels(*make_scene(20_000, 0.008, seed=2))


def test_backward_kernels_empty_tiles_and_ragged_batches():
    """A sparse scene: some tiles hold no pair at all, and the tiles that
    do hold pair counts that are not a multiple of K3's 64-pair batch."""
    feat9, prep, cfg = make_scene(60, 0.03, seed=3)
    pairs = check_backward_kernels(feat9, prep, cfg)
    counts = pairs.tile_counts
    assert bool((counts == 0).any()) and bool((counts % 64 != 0).any())


K4_CASES = ["empty_segments", "clipped_at_capacity", "long_segment",
            "ragged_block", "unaligned_span", "single_gaussian"]


@pytest.mark.parametrize("case", K4_CASES)
def test_segment_sum_kernel_edge_cases(case):
    """K4 bit for bit against the float32 slot-order sum: gaussians with no
    pairs, segments cut at (and wholly past) the capacity, one segment
    longer than the 512-row staging chunk, N not a multiple of the
    256-gaussian block, a block whose span starts off a 16-byte boundary
    (36-byte rows), and N = 1."""
    need_cuda()
    rng = np.random.default_rng(5)
    N = {"ragged_block": 300, "unaligned_span": 600,
         "single_gaussian": 1}.get(case, 512)
    counts = rng.integers(0, 7, size=N)
    if case == "empty_segments":
        counts[rng.random(N) < 0.6] = 0
        counts[:256] = 0                      # a block with an empty span
    elif case == "long_segment":
        counts[300] = 3000
    elif case == "unaligned_span":
        counts[:256] = 1
        counts[7] = 2                         # block 1 starts at slot 257
    elif case == "single_gaussian":
        counts[0] = 5
    total = int(counts.sum())
    K = total - 40 if case == "clipped_at_capacity" else total + 3
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if case == "unaligned_span":
        assert offsets[256] * 9 % 4 != 0
    dp = torch.tensor(rng.normal(size=(K, 9)).astype(np.float32),
                      device="cuda")
    off = torch.tensor(offsets, dtype=torch.int64, device="cuda")
    cnt = torch.tensor(counts.astype(np.int32), device="cuda")
    got = [segment_sum_cuda(dp, off, cnt) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], segment_sum_slot_order(dp, off, cnt))
    assert not got[0][cnt == 0].ne(0).any()


def test_segment_sum_kernel_no_gaussians():
    need_cuda()
    out = segment_sum_cuda(
        torch.zeros((8, 9), device="cuda"),
        torch.zeros(0, dtype=torch.int64, device="cuda"),
        torch.zeros(0, dtype=torch.int32, device="cuda"))
    assert out.shape == (0, 9)


def test_rasterize_grads_match_cpu(scene):
    """The whole backward on the card (K3, K4, then autograd through
    preprocess and the activations) against the CPU path on the same
    inputs: >= 99.9% of each input's gradient values within atol 5e-5 /
    rtol 5e-3 (PARITY.md:45); the rest are pixels where the kernels and the
    plain compositor stop at a T < 1e-4 knife edge apart."""
    from gs2mesh_torch.ops.rasterizer import rasterize

    _, _, cfg = scene
    rng = np.random.default_rng(1)
    n = 3000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = rng.normal(size=(n, 4))
    arrays = [np.asarray(a, np.float32) for a in (
        v, np.abs(rng.normal(0.05, 0.015, size=(n, 3))) + 1e-3,
        q / np.linalg.norm(q, axis=1, keepdims=True),
        rng.uniform(0.3, 0.95, n), rng.normal(scale=0.3, size=(n, 16, 3)))]
    grads = {}
    for dev in ("cuda", "cpu"):
        inputs = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in arrays]
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]),
                          math.radians(60), math.radians(45), W, H,
                          device=dev)
        out = rasterize(*inputs, cam, 3, cfg=cfg,
                        bg=torch.tensor([0.1, 0.2, 0.3], device=dev))
        loss = torch.mean(out.image ** 2) + 0.1 * torch.mean(out.final_T)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, inputs)]
    for name, g, ref in zip(("means3d", "scales", "rotations", "opacities",
                             "shs"), grads["cuda"], grads["cpu"]):
        assert ref.abs().max() > 0, name
        ok = (g - ref).abs() <= 5e-5 + 5e-3 * ref.abs()
        assert float(ok.float().mean()) >= 0.999, name


def test_preprocess_kernels_match_plain():
    """P1 bit-equal to preprocess_plain on the pair-deciding outputs (rgb
    within 1e-6); P2 within 1e-5 relative plus 1e-6 of each column's
    largest gradient of preprocess_backward_plain; both bit-identical
    across two runs."""
    from gs2mesh_torch.ops.rasterizer.preprocess import (
        preprocess_backward_cuda, preprocess_backward_plain,
        preprocess_forward_cuda, preprocess_plain)

    need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 3000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:100, 2] = -10.0                          # behind the camera
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.3, 0.95, n)
    op[100:200] = 0.0
    x = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in (
        v, np.abs(rng.normal(0.05, 0.015, size=(n, 3))) + 1e-3, q, op,
        rng.normal(scale=0.3, size=(n, 16, 3)))]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), math.radians(60),
                      math.radians(45), W, H, device=dev)
    cfg = RasterizerConfig(pair_capacity=1 << 16)
    with torch.no_grad():
        k = preprocess_forward_cuda(*x, cam, 3, cfg, 1.0)
        again = preprocess_forward_cuda(*x, cam, 3, cfg, 1.0)
        p = preprocess_plain(*x, cam, 3, cfg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, again))
        for name, a in zip(("means2d", "depths", "conic", "rgb", "radius",
                            "rect", "tiles_touched"), k):
            if name == "rgb":
                assert float((a - p.rgb).abs().max()) <= 1e-6
            else:
                assert torch.equal(a, getattr(p, name)), name
        cot = [torch.tensor(rng.normal(size=(n, c)).astype(np.float32),
                            device=dev) for c in (2, 3, 3)]
        args = (x[0], x[1], x[2], x[4], cam, 3, cfg, 1.0, *cot)
        g = preprocess_backward_cuda(*args)
        g2 = preprocess_backward_cuda(*args)
        gp = preprocess_backward_plain(*args)
        torch.cuda.synchronize()
    for a, b, c in zip(g, g2, gp):
        assert torch.equal(a, b)
        a, c = a.reshape(n, -1), c.reshape(n, -1)
        assert bool(((a - c).abs() <= 1e-5 * c.abs()
                     + 1e-6 * c.abs().amax(0)).all())
