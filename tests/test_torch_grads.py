"""Gradients of the PyTorch port's rasterizer against the JAX package's
exact-carry rasterizer, on the CPU (plain versions of kernels K3 and K4).

Scenes, camera and capacity are those of tests/test_rasterizer.py (96x64,
pair_capacity 1<<14). The loss is mean(image^2) + 0.1 * mean(final_T), so
both cotangents of the compositor are nonzero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.ops.rasterizer import rasterize as j_rasterize
from gs2mesh_tpu.ops.rasterizer.emit import FEAT, _reduce_sorted_cts
from gs2mesh_tpu.ops.rasterizer.emit import build_feat9 as j_build_feat9
from gs2mesh_tpu.ops.rasterizer.emit import emit_sorted_pairs
from gs2mesh_tpu.ops.rasterizer.pallas_kernels import render_tiles_pallas
from gs2mesh_tpu.ops.rasterizer.tile_render import \
    assemble_image as j_assemble_image
from gs2mesh_torch.ops.rasterizer import rasterize
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emit_pairs,
                                               segment_sum_plain, sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.ops.rasterizer.tile_render import (composite_backward_plain,
                                                      pair_rows)
from tests import test_rasterizer as tr
from tests.test_torch_rasterizer import (BG, CAM, CFG, NUM_TILES, jax_args,
                                         scene_np, torch_args)

torch.set_num_threads(1)

# PARITY.md:45: gradients within atol 5e-5, rtol 5e-3.
ATOL, RTOL = 5e-5, 5e-3
NAMES = ("means3d", "scales", "rotations", "opacities", "shs", "bg",
         "screenspace_offset")


def torch_loss(out):
    return torch.mean(out.image ** 2) + 0.1 * torch.mean(out.final_T)


@functools.partial(jax.jit, static_argnames=("impl", "sh_degree"))
def jax_grads(args, bg, offs, impl, sh_degree):
    def loss(*a):
        out = j_rasterize(*a[:5], tr.CAM, sh_degree, bg=a[5], cfg=tr.CFG,
                          impl=impl, max_per_tile=2048,
                          screenspace_offset=a[6])
        return jnp.mean(out.image ** 2) + 0.1 * jnp.mean(out.final_T)
    return jax.grad(loss, argnums=tuple(range(7)))(*args, bg, offs)


def torch_grads(arrays, sh_degree):
    inputs = [t.requires_grad_(True) for t in torch_args(arrays)]
    bg = BG.clone().requires_grad_(True)
    offs = torch.zeros((inputs[0].shape[0], 2), requires_grad=True)
    out = rasterize(*inputs, CAM, sh_degree, bg=bg, cfg=CFG,
                    screenspace_offset=offs)
    assert not bool(out.overflow) and not bool(out.tile_overflow)
    return torch.autograd.grad(torch_loss(out), inputs + [bg, offs])


@pytest.mark.parametrize("impl,n,sh_degree", [("xla", 256, 0),
                                              ("xla", 128, 3),
                                              ("pallas", 96, 0)])
def test_rasterize_grads_match_jax(impl, n, sh_degree):
    """All five inputs, bg and the screen-space probe, against JAX autodiff
    (impl='xla') and the Pallas backward kernel (impl='pallas', interpret)."""
    arrays = scene_np(n, sh_degree)
    ref = jax_grads(jax_args(arrays), jnp.asarray(BG.numpy()),
                    jnp.zeros((n, 2), jnp.float32), impl, sh_degree)
    got = torch_grads(arrays, sh_degree)
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@jax.jit
def jax_pair_grads(args, dC, dTf):
    """Per-pair gradients at sorted positions from the positional Pallas
    backward (_bwd_call through render_tiles_pallas's VJP)."""
    prep = tr.run_preprocess(args)
    pair_feat, aux = emit_sorted_pairs(
        j_build_feat9(prep), prep.depths, prep.rect, prep.tiles_touched,
        tr.CAM.width, tr.CAM.height, tr.CFG)
    gx, gy = tr.CFG.grid_size(tr.CAM.width, tr.CAM.height)

    def render(pf):
        c, t = render_tiles_pallas(pf, aux.tile_starts, aux.tile_counts, gx,
                                   gy, tr.CFG)
        return j_assemble_image(c, t, gx, gy, tr.CAM.width, tr.CAM.height,
                                tr.CFG.tile)

    _, vjp = jax.vjp(render, pair_feat)
    (dpf,) = vjp((dC, dTf))
    K = tr.CFG.pair_capacity
    return dpf[:K // tr.CFG.chunk].transpose(0, 2, 1).reshape(K, FEAT)[:, :9]


def test_pair_grads_match_jax_bwd_call():
    """composite_backward_plain (the plain version of K3) against the
    positional Pallas backward, pair by pair. Sorted orders are equal (the
    keys match exactly, tests/test_torch_rasterizer.py). Tolerance: 5e-3
    relative plus 1e-4 of each column's largest gradient; the Pallas kernel
    forms the conic and mean gradients as differences of pixel moments, so
    small per-pair values carry cancellation error on that scale."""
    arrays = scene_np(256)
    rng = np.random.default_rng(7)
    dC = rng.normal(size=(3, CAM.height, CAM.width)).astype(np.float32)
    dTf = rng.normal(size=(CAM.height, CAM.width)).astype(np.float32)
    ref = np.asarray(jax_pair_grads(jax_args(arrays), jnp.asarray(dC),
                                    jnp.asarray(dTf)))
    prep = preprocess(*torch_args(arrays), CAM, 0, CFG)
    feat9 = build_feat9(prep)
    pairs = sort_pairs(emit_pairs(feat9, prep.depths, prep.rect,
                                  prep.tiles_touched, CAM.width, CAM.height,
                                  CFG), NUM_TILES)
    got = composite_backward_plain(
        pair_rows(feat9, pairs.ids), pairs.tile_starts, pairs.tile_counts,
        torch.from_numpy(dC), torch.from_numpy(dTf), CAM.width, CAM.height,
        CFG).numpy()
    live = int(pairs.tile_counts.sum())
    assert np.count_nonzero(got[:live].any(axis=1)) > live // 2
    np.testing.assert_array_equal(got[live:], 0.0)
    bad = np.abs(got - ref) > 5e-3 * np.abs(ref) + 1e-4 * np.abs(ref).max(0)
    assert not bad.any(), np.argwhere(bad)[:10]


def test_segment_sum_matches_segment_sum_tpu():
    """segment_sum_plain (the plain version of K4) over emission-order
    per-pair rows against the Pallas segment sum (interpret mode) fed the
    same rows with their gaussian ids, as tests/test_emit_pallas.py does."""
    rng = np.random.default_rng(0)
    n_rows, chunk = 300, tr.CFG.chunk
    counts = rng.integers(0, 12, size=n_rows).astype(np.int32)
    counts[[0, 17, 299]] = 0
    total = int(counts.sum())
    K = -(-(total + 5) // chunk) * chunk         # a few unused slots
    dp = np.zeros((K, 9), np.float32)
    dp[:total] = rng.normal(size=(total, 9))
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    ids = np.full(K, (1 << 22) - 1, np.int32)
    ids[:total] = np.repeat(np.arange(n_rows), counts)

    ct = np.zeros((K, FEAT), np.float32)
    ct[:, :9] = dp
    ct3d = ct.reshape(K // chunk, chunk, FEAT).transpose(0, 2, 1)
    ref = np.asarray(_reduce_sorted_cts(jnp.asarray(ct3d),
                                        jnp.asarray(ids.reshape(-1, chunk)),
                                        n_rows, tr.CFG))[:, :9]
    got = segment_sum_plain(torch.from_numpy(dp), torch.from_numpy(offsets),
                            torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[counts == 0], 0.0)
