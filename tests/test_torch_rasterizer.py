"""Parity of the PyTorch port's rasterizer with the JAX package's exact-carry
rasterizer, on the CPU (plain versions of kernels K1 and K2).

Scenes, camera and capacity are those of tests/test_rasterizer.py (96x64,
pair_capacity 1<<14), and the JAX side reuses its jitted functions.
Tolerances follow PARITY.md: images and final_T within 2e-5; integer fields,
keys, sorted ids and tile ranges exact; float preprocess fields within rtol
1e-5 (plus 1e-6 of the field's largest magnitude, for the conic b term,
which cancels).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.ops.rasterizer.emit import build_feat9 as j_build_feat9
from gs2mesh_tpu.ops.rasterizer.emit import emission_core
from gs2mesh_tpu.ops.rasterizer.preprocess import preprocess as j_preprocess
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emission_plain,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from tests import test_rasterizer as tr
from tests.scenes import sphere_scene
from tests.test_torch_core import assert_camera_close, look_at_camera

torch.set_num_threads(1)

CFG = RasterizerConfig(pair_capacity=tr.CFG.pair_capacity)
CAM = look_at_camera((0.0, 0.0, -3.0), tr.CAM.width, tr.CAM.height)
BG = torch.tensor([0.1, 0.2, 0.3])
KEYS = ("means3d", "scales", "rotations", "opacities", "shs")
NUM_TILES = np.prod(CFG.grid_size(CAM.width, CAM.height))


@functools.lru_cache(maxsize=None)
def scene_np(n, sh_degree=0, cull_mid=False):
    s = sphere_scene(n=n, sh_degree=sh_degree)
    if cull_mid:   # gaussians 30..49 behind the camera: culled mid-array
        s["means3d"][30:50, 2] = -10.0
    return tuple(s[k] for k in KEYS)


def jax_args(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def torch_args(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@jax.jit
def run_preprocess_sh3(args):
    return j_preprocess(*args, tr.CAM, 3, tr.CFG)


@jax.jit
def run_emission(prep):
    return emission_core(j_build_feat9(prep), prep.depths, prep.rect,
                         prep.tiles_touched, tr.CAM.width, tr.CAM.height,
                         tr.CFG)


def assert_prep_matches(got, ref):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=f)


def test_camera_matches_test_rasterizer_camera():
    assert_camera_close(CAM, tr.CAM)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_preprocess_matches_jax(sh_degree):
    arrays = scene_np(256, sh_degree)
    run = tr.run_preprocess if sh_degree == 0 else run_preprocess_sh3
    ref = run(jax_args(arrays))
    got = preprocess(*torch_args(arrays), CAM, sh_degree, CFG)
    assert_prep_matches(got, ref)
    assert int((got.radius > 0).sum()) > 64


@pytest.mark.parametrize("cull_mid", [False, True])
def test_emission_matches_jax(cull_mid):
    arrays = scene_np(256 if not cull_mid else 128, cull_mid=cull_mid)
    jprep = tr.run_preprocess(jax_args(arrays))
    ref = run_emission(jprep)
    prep = preprocess(*torch_args(arrays), CAM, 0, CFG)
    em = emission_plain(build_feat9(prep), prep.depths, prep.rect,
                        prep.tiles_touched, CAM.width, CAM.height, CFG)
    assert int(em.num_pairs) == int(ref.num_pairs) > 0
    assert not bool(em.overflow)
    np.testing.assert_array_equal(em.keys.numpy(),
                                  np.asarray(ref.key).astype(np.int64))
    np.testing.assert_array_equal(em.ids.numpy(),
                                  np.asarray(ref.emission_ids))

    pairs = sort_pairs(em, NUM_TILES)
    ref_ids = jax.lax.sort((ref.key, ref.emission_ids), num_keys=1,
                           is_stable=True)[1]
    np.testing.assert_array_equal(pairs.ids.numpy(), np.asarray(ref_ids))
    b = tr.run_binning(jprep)
    np.testing.assert_array_equal(pairs.tile_starts.numpy(),
                                  np.asarray(b.tile_starts))
    np.testing.assert_array_equal(pairs.tile_counts.numpy(),
                                  np.asarray(b.tile_counts))
    live = int(pairs.tile_counts.sum())
    np.testing.assert_array_equal(pairs.ids[:live].numpy(),
                                  np.asarray(b.pair_ids)[:live])
    if cull_mid:
        ids = pairs.ids[:live].numpy()
        assert not np.any((ids >= 30) & (ids < 50))


@pytest.mark.parametrize("impl,cull_mid", [("xla", False), ("xla", True),
                                           ("pallas", False)])
def test_render_matches_jax(impl, cull_mid):
    """Against JAX rasterize(impl='xla') and impl='pallas' (the TPU kernels
    in interpret mode), both exact-carry."""
    arrays = scene_np(256 if not cull_mid else 128, cull_mid=cull_mid)
    run = tr.run_xla if impl == "xla" else tr.run_pallas
    ref = run(jax_args(arrays))
    out = rasterize(*torch_args(arrays), CAM, 0, bg=BG, cfg=CFG)
    assert not bool(out.overflow) and not bool(out.tile_overflow)
    assert int(out.num_pairs) == int(ref.num_pairs)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.final_T.numpy(), np.asarray(ref.final_T),
                               atol=2e-5, rtol=0)
    assert float(out.final_T.min()) < 0.5     # the sphere covers pixels


def test_overflow_reported_with_finite_output():
    arrays = torch_args(scene_np(256))
    out = rasterize(*arrays, CAM, 0, bg=BG,
                    cfg=RasterizerConfig(pair_capacity=256))
    assert bool(out.overflow) and int(out.num_pairs) > 256
    assert torch.isfinite(out.image).all() and torch.isfinite(out.final_T).all()


def test_tile_overflow_reported():
    arrays = torch_args(scene_np(256))
    out = rasterize(*arrays, CAM, 0, bg=BG, cfg=CFG, max_per_tile=8)
    assert bool(out.tile_overflow) and not bool(out.overflow)
    assert torch.isfinite(out.image).all()


def test_cpu_tensors_never_reach_kernels():
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda

    arrays = torch_args(scene_np(64))
    before = (emission_cuda.launches, composite_cuda.launches)
    rasterize(*arrays, CAM, 0, cfg=CFG)
    assert (emission_cuda.launches, composite_cuda.launches) == before
    prep = preprocess(*arrays, CAM, 0, CFG)
    with pytest.raises(ValueError, match="expected cuda"):
        emission_cuda(build_feat9(prep), prep.depths, prep.rect,
                      prep.tiles_touched, CAM.width, CAM.height, CFG)
