"""CUDA kernels K1 (emission) and K2 (compositing) against their plain
PyTorch versions on the card. Marked ``cuda``; each test skips without a
CUDA device. This file imports neither JAX nor the test scenes (which do),
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from gs2mesh_torch.core.camera import make_camera
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emission_cuda,
                                               emission_plain, sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.ops.rasterizer.tile_render import composite_plain

pytestmark = pytest.mark.cuda
W, H = 200, 136                       # ragged last tile row and column


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same "
                    "kernel-vs-plain checks on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 3000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scales = np.abs(rng.normal(0.05, 0.015, size=(n, 3))) + 1e-3
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


def test_composite_kernel_matches_plain(scene):
    feat9, prep, cfg = scene
    gx, gy = cfg.grid_size(W, H)
    pairs = sort_pairs(emission_cuda(feat9, prep.depths, prep.rect,
                                     prep.tiles_touched, W, H, cfg), gx * gy)
    a = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H, cfg)
    color, T = composite_cuda(*a)
    ref = composite_plain(*a, max_per_tile=int(pairs.tile_counts.max()))
    torch.cuda.synchronize()
    d = torch.cat([(color - ref.color).abs().flatten(),
                   (T - ref.final_T).abs().flatten()])
    assert float((d > 2e-5).float().mean()) <= 1e-4
    assert float(d.max()) <= 4e-3
