"""The port's TSDF stage, masker contract and TSDF flags
(gs2mesh_torch.pipeline) against the JAX package's, on the CPU.

Both stages read the same NNN/ artifacts through a renderer stub: left.png,
the analytic depth of a sphere, an occlusion mask and a masker's
left_mask.npy, for 6 views at 64x64 around the sphere (the TSDF half of
tests/test_pipeline.py::test_stereo_and_tsdf_stages, with its voxel 16/512,
trunc 0.2 and baseline band). JAX's stage fuses in one jitted step a view;
the port follows JAX's eager arithmetic, so the two volumes may differ in
the last bits: the meshes and cleaned meshes must have equal faces, and
vertices and colours within 1e-6.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from gs2mesh_tpu.pipeline import TSDF as JTSDF
from gs2mesh_tpu.pipeline.config import PipelineArgs as JArgs
from gs2mesh_tpu.pipeline.masker_stage import CopyMasker as JCopyMasker
from gs2mesh_tpu.pipeline.masker_stage import FullMasker as JFullMasker
from gs2mesh_tpu.pipeline.masker_stage import morph_close_erode as j_morph
from gs2mesh_torch.core.ply import read_ply
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.pipeline import (TSDF, CopyMasker, FullMasker,
                                    PipelineArgs)
from gs2mesh_torch.pipeline import tsdf_stage
from gs2mesh_torch.pipeline.config import DATASETS
from gs2mesh_torch.pipeline.masker_stage import morph_close_erode
from tests.test_fusion import look_at_extrinsic, make_K, sphere_depth

torch.set_num_threads(1)

H = W = 64
N_VIEWS = 6
MODEL = "DLNR_Middlebury"


class StubRenderer:
    """The renderer's interface to the TSDF stage and the maskers: N_VIEWS
    cameras on a ring at 3 * scale around a sphere of radius scale."""

    def __init__(self, root, scale):
        self.output_dir_root = root
        self.baseline = 0.15 * scale
        K = make_K(W, H, f=70.0)
        self.left_cameras, self.w2c = [], []
        for i in range(N_VIEWS):
            th = 2 * np.pi * i / N_VIEWS
            E = look_at_extrinsic(scale * np.array(
                [3.0 * np.cos(th), 3.0 * np.sin(th), 0.6 * np.sin(2 * th)]))
            self.w2c.append(E)
            self.left_cameras.append(dict(
                width=W, height=H, fx=float(K[0, 0]), fy=float(K[1, 1]),
                cx=float(K[0, 2]), cy=float(K[1, 2]),
                extrinsic=np.linalg.inv(E.astype(np.float64))))
        self.K = K
        self.visited = []

    def __len__(self):
        return N_VIEWS

    def render_folder_name(self, i):
        self.visited.append(i)
        return os.path.join(self.output_dir_root, f"{i:03}")


class StubStereo:
    model_name = MODEL


def disk_mask(i):
    """A mask that keeps most of the sphere and cuts a notch (so close and
    erode change it)."""
    yy, xx = np.mgrid[0:H, 0:W]
    m = (xx - W / 2) ** 2 + (yy - H / 2) ** 2 < (0.42 * W) ** 2
    m[H // 2 - 2:H // 2 + 2, : W // 2 + i] = False
    return m


def write_views(root, scale, masker):
    """Both packages' artifact trees (identical files) under root/{jax,
    port}; returns the two stub renderers."""
    stubs = {}
    for side in ("jax", "port"):
        r = StubRenderer(str(root / side), scale)
        for i, E in enumerate(r.w2c):
            d = os.path.join(r.output_dir_root, f"{i:03}")
            os.makedirs(os.path.join(d, f"out_{MODEL}"))
            img = np.random.default_rng(i).integers(0, 256, (H, W, 3),
                                                    dtype=np.uint8)
            write_png(os.path.join(d, "left.png"), img)
            depth = sphere_depth(r.K, E, W, H, radius=scale)
            np.save(os.path.join(d, f"out_{MODEL}", "depth.npy"), depth)
            occ = np.random.default_rng(10 + i).random((H, W)) > 0.02
            np.save(os.path.join(d, f"out_{MODEL}", "occlusion_mask.npy"),
                    occ)
        stubs[side] = r
    if masker == "full":
        JFullMasker(stubs["jax"]).segment()
        FullMasker(stubs["port"]).segment()
    else:
        JCopyMasker(stubs["jax"], disk_mask).segment()
        CopyMasker(stubs["port"], disk_mask).segment()
    for r in stubs.values():
        r.visited.clear()
    return stubs


def stage_args(Args, scale, erode, **kw):
    args = Args.for_dataset("custom", TSDF_scale=scale,
                            TSDF_erode_mask=erode, TSDF_use_mask=True,
                            TSDF_voxel=16, TSDF_sdf_trunc=0.2,
                            TSDF_min_depth_baselines=1,
                            TSDF_max_depth_baselines=30,
                            TSDF_cleaning_threshold=10,
                            TSDF_erosion_kernel_size=3,
                            TSDF_closing_kernel_size=4, **kw)
    return args


def run_both(tmp_path, scale, erode, masker, capacity=1024, **kw):
    stubs = write_views(tmp_path, scale, masker)
    out = {}
    for side, Stage, Args, extra in (("jax", JTSDF, JArgs, {}),
                                     ("port", TSDF, PipelineArgs,
                                      {"device": "cpu"})):
        stage = Stage(stubs[side], StubStereo(),
                      stage_args(Args, scale, erode, **kw), "tsdf", **extra)
        stage.run(block_capacity=capacity)
        visited = list(stubs[side].visited)
        paths = (stage.save_mesh(), stage.clean_mesh())
        out[side] = (stage, visited, paths)
    return out


def assert_meshes_match(p, j):
    assert p.faces.shape[0] > 100
    np.testing.assert_array_equal(p.faces, j.faces)
    np.testing.assert_allclose(p.vertices, j.vertices, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.vertex_colors, j.vertex_colors, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p.vertex_normals, j.vertex_normals, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("scale,erode,masker", [
    (1.0, False, "full"), (1.0, True, "copy"), (0.1, True, "full"),
    (0.1, False, "copy")], ids=["s1-full", "s1-erode-copy", "s0.1-erode-full",
                                "s0.1-copy"])
def test_stage_matches_jax(tmp_path, scale, erode, masker):
    out = run_both(tmp_path, scale, erode, masker)
    (ps, pv, ppaths), (js, jv, jpaths) = out["port"], out["jax"]
    assert pv == jv == list(range(N_VIEWS))
    assert_meshes_match(ps.mesh, js.mesh)
    assert_meshes_match(ps.cleaned, js.cleaned)
    for path, mesh in zip(ppaths, (ps.mesh, ps.cleaned)):
        d = read_ply(path)
        np.testing.assert_array_equal(d.positions, mesh.vertices)
        np.testing.assert_array_equal(d.faces, mesh.faces)
    # The surface is the sphere of radius `scale`, in world units.
    r = np.linalg.norm(ps.cleaned.vertices, axis=1)
    assert abs(np.median(r) - scale) < 0.05 * scale


def test_stage_grows_like_jax(tmp_path, monkeypatch):
    """block_capacity 64 overflows on the first view: both stages double it
    until it fits and end with the same mesh. (JAX's stage calls
    ``fusion.grow_volume``, which its fusion package does not export; the
    test supplies the name.)"""
    from gs2mesh_tpu import fusion as j_fusion
    from gs2mesh_tpu.fusion.tsdf import grow_volume

    assert not hasattr(j_fusion, "grow_volume")
    monkeypatch.setattr(j_fusion, "grow_volume", grow_volume, raising=False)
    out = run_both(tmp_path, 1.0, True, "copy", capacity=64)
    ps, js = out["port"][0], out["jax"][0]
    assert ps.cfg.block_capacity > 64
    assert ps.volume.n_blocks > 64 and not ps.volume.overflow
    assert_meshes_match(ps.mesh, js.mesh)
    assert_meshes_match(ps.cleaned, js.cleaned)


@pytest.mark.parametrize("kw", [
    dict(TSDF_dilate=2), dict(TSDF_valid=[0, 1, 4, 5]),
    dict(TSDF_skip=[1, 2]), dict(TSDF_dilate=2, TSDF_skip=[4],
                                 TSDF_valid=[0, 2, 4, 5])],
    ids=["dilate", "valid", "skip", "all"])
def test_view_filters_choose_the_same_views(tmp_path, kw):
    stubs = write_views(tmp_path, 1.0, "full")
    args = stage_args(PipelineArgs, 1.0, False, **kw)
    port = TSDF(stubs["port"], StubStereo(), args, "t", device="cpu")
    chosen = [i for i, _ in port.views()]
    jargs = stage_args(JArgs, 1.0, False, **kw)
    JTSDF(stubs["jax"], StubStereo(), jargs, "t").run(block_capacity=1024)
    assert chosen == stubs["jax"].visited
    assert 0 < len(chosen) < N_VIEWS


def test_stage_defaults_to_cuda_and_never_falls_back(tmp_path, monkeypatch):
    assert inspect.signature(TSDF).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = StubRenderer(str(tmp_path), 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        TSDF(r, StubStereo(), PipelineArgs(), "t")
    assert tsdf_stage.STAGE_RANGES == ("read", "mask", "allocate",
                                       "integrate", "extract", "clean",
                                       "write")


@pytest.mark.parametrize("dataset", DATASETS)
def test_tsdf_flags_match_jax(dataset):
    a, b = PipelineArgs.for_dataset(dataset), JArgs.for_dataset(dataset)
    names = [k for k in vars(a) if k.startswith("TSDF_")]
    assert len(names) == 15
    for k in vars(a):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("k", [1, 2, 3, 10])
def test_morph_close_erode_matches_jax(k):
    rng = np.random.default_rng(k)
    for density in (0.5, 0.9):
        m = rng.random((37, 52)) < density
        for closing, erosion in ((k, k), (k, 1), (1, k), (k, 3)):
            got = morph_close_erode(m, closing, erosion)
            ref = j_morph(m, closing, erosion)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("masker", ["full", "copy"])
def test_maskers_write_jax_contract(tmp_path, masker):
    stubs = write_views(tmp_path, 1.0, masker)
    for i in range(N_VIEWS):
        p = os.path.join(stubs["port"].output_dir_root, f"{i:03}")
        j = os.path.join(stubs["jax"].output_dir_root, f"{i:03}")
        a = np.load(os.path.join(p, "left_mask.npy"))
        b = np.load(os.path.join(j, "left_mask.npy"))
        assert a.dtype == b.dtype == np.bool_
        np.testing.assert_array_equal(a, b)
        png = read_png(os.path.join(p, "left_mask.png"))
        np.testing.assert_array_equal(png, a.astype(np.uint8) * 255)
        np.testing.assert_array_equal(
            png, read_png(os.path.join(j, "left_mask.png")))
