"""The PyTorch port's stereo-pair Renderer against the JAX Renderer on the
synthetic COLMAP model + GS PLY of tests/test_pipeline.py, on the CPU.

The JAX side renders in exact-carry mode (its default packed bf16 carry is
a TPU speed trade, not the reference semantics). camera_data.json must agree
within 1e-9, float renders within 2e-5, PNGs within 1 LSB.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import gs2mesh_tpu.ops.rasterizer as j_rasterizer
from gs2mesh_tpu.pipeline import PipelineArgs as JArgs
from gs2mesh_tpu.pipeline import Renderer as JRenderer
from gs2mesh_torch.pipeline import PipelineArgs, Renderer
from gs2mesh_torch.pipeline.renderer_stage import write_png
from tests.test_pipeline import H, N_VIEWS, W, _write_colmap_model, _write_gs_ply

torch.set_num_threads(1)

CAPACITY = 1 << 15


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_pipe"))
    colmap_dir = os.path.join(base, "colmap")
    _write_colmap_model(colmap_dir)
    ply = os.path.join(base, "point_cloud.ply")
    _write_gs_ply(ply)
    return base, colmap_dir, ply


@pytest.fixture(scope="module")
def renders(scene):
    """Both renderers over every view: (port, jax) dicts of output dir,
    renderer and float images per view."""
    base, colmap_dir, ply = scene
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(j_rasterizer, "RasterizerConfig", functools.partial(
        j_rasterizer.RasterizerConfig, feat_carry_bf16=False,
        grad_carry_bf16=False))
    try:
        for name, Args, R, kw in (("jax", JArgs, JRenderer, {}),
                                  ("port", PipelineArgs, Renderer,
                                   {"device": "cpu"})):
            args = Args.for_dataset("custom", colmap_name="synth")
            root = os.path.join(base, name)
            r = R(base, colmap_dir, root, args, ply_path=ply, **kw)
            r.prepare_renderer(pair_capacity=CAPACITY)
            imgs = [r.render_image_pair(i) for i in range(len(r))]
            out[name] = (root, r, imgs)
    finally:
        mp.undo()
    return out


def test_camera_data_matches_jax(renders):
    (proot, pr, _), (jroot, jr, _) = renders["port"], renders["jax"]
    assert len(pr) == len(jr) == N_VIEWS
    assert pr.baseline == jr.baseline > 0
    with open(os.path.join(proot, "camera_data.json")) as f:
        got = json.load(f)
    with open(os.path.join(jroot, "camera_data.json")) as f:
        ref = json.load(f)
    assert len(got) == len(ref) == N_VIEWS
    for g, r in zip(got, ref):
        for side in ("left", "right"):
            assert g[side].keys() == r[side].keys()
            for k in r[side]:
                np.testing.assert_allclose(np.asarray(g[side][k], float),
                                           np.asarray(r[side][k], float),
                                           rtol=0, atol=1e-9, err_msg=k)


def test_renders_match_jax(renders):
    (proot, pr, pimgs), (jroot, _, jimgs) = renders["port"], renders["jax"]
    for i in range(N_VIEWS):
        for side in ("left", "right"):
            got, ref = pimgs[i][side], np.asarray(jimgs[i][side])
            assert got.shape == ref.shape == (H, W, 3)
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
            a = np.asarray(Image.open(os.path.join(
                pr.render_folder_name(i), f"{side}.png")), np.int16)
            b = np.asarray(Image.open(os.path.join(
                jroot, f"{i:03}", f"{side}.png")), np.int16)
            assert a.shape == b.shape == (H, W, 3)
            assert np.abs(a - b).max() <= 1
        diff = np.abs(pimgs[i]["left"] - pimgs[i]["right"]).mean()
        assert 0 < diff < 0.5
    assert not bool(pr.last_output.overflow)


def test_png_writer_roundtrip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3), np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_renderer_raises_on_pair_overflow(scene, tmp_path):
    base, colmap_dir, ply = scene
    pr = Renderer(base, colmap_dir, str(tmp_path),
                  PipelineArgs.for_dataset("custom", colmap_name="synth"),
                  ply_path=ply, device="cpu")
    pr.prepare_renderer(pair_capacity=64)
    with pytest.raises(RuntimeError, match="pair_capacity"):
        pr.render_single(pr.cameras[0]["left"])
