"""The port's GS tools (gs2mesh_torch.cli.gs_tools: gs_render, gs_metrics,
gs_full_eval) against the JAX package's on a 64x64 scene, on the CPU.

JAX renders in the exact-carry mode the port implements
(RasterizerConfig(feat_carry_bf16=False), as every port test holds it).
Limits: the PNG renders within 1/255 of JAX's; metrics on the same renders
within 1e-5 (SSIM, PSNR) and 2e-4 relative (LPIPS, tests/test_lpips.py's).
gs_full_eval trains both packages from the same scene, so their renders
differ by the trained parameters' float32 gap: renders within 1/255, the
metrics within 1e-3 relative.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import gs2mesh_tpu.ops.rasterizer as jrasterizer
from gs2mesh_tpu.cli import gs_tools as jtools
from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from gs2mesh_torch.cli import gs_tools
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz
from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
from gs2mesh_torch.ops.rasterizer import rasterize
from tests.scenes import sphere_scene
from tests.test_torch_core import look_at_camera
from tests.test_torch_gs_tools import (CFG, EXACT, EYES, KEYS,
                                       write_lpips_weights)

torch.set_num_threads(1)


def write_scene(src, n=300, seed=2, size=64):
    """A binary COLMAP model (4 views, the scene's noisy centres as
    points3D) with PNG targets rendered by the port; returns the target
    model's dict (SH degree 3, as gs_train's models)."""
    s = sphere_scene(n=n, seed=seed, sh_degree=3)
    target = {k: torch.from_numpy(s[k]) for k in KEYS}
    os.makedirs(os.path.join(src, "images"))
    imgs = {}
    for i, e in enumerate(EYES):
        cam = look_at_camera(e, size, size)
        with torch.no_grad():
            img = rasterize(*(target[k] for k in KEYS), cam, 3, cfg=CFG).image
        w2v = cam.world_view.numpy().T.astype(np.float64)
        imgs[i + 1] = colmap_io.ColmapImage(
            i + 1, rotmat2qvec_wxyz(w2v[:3, :3]), w2v[:3, 3], 1,
            f"{i:03}.png", np.zeros((0, 2)), np.zeros((0,), np.int64))
        write_png(os.path.join(src, "images", f"{i:03}.png"),
                  (img.clamp(0, 1) * 255).round().to(torch.uint8)
                  .permute(1, 2, 0).numpy())
    f = float(cam.focal_x)
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", size, size,
                                      np.array([f, f, size / 2, size / 2]))}
    empty = np.zeros((0,), np.int64)
    rng = np.random.default_rng(seed)
    pts = {i + 1: colmap_io.ColmapPoint3D(
        i + 1, (p + rng.normal(0, 0.02, 3)).astype(np.float64),
        np.array([128, 100, 90]), 0.0, empty, empty)
        for i, p in enumerate(s["means3d"])}
    colmap_io.write_model_binary(os.path.join(src, "sparse", "0"), cams, imgs,
                                 pts)
    return s


@pytest.fixture()
def exact_jax(monkeypatch):
    """JAX's GS tools render through RasterizerConfig(...) built in the
    function: give them the exact-carry mode the port implements, and a
    pair capacity of 1 << 15 (a 64x64 view never fills it; 1 << 22 makes
    the CPU's XLA render take ~20 s)."""
    monkeypatch.setattr(jrasterizer, "RasterizerConfig",
                        lambda **kw: JRasterizerConfig(
                            **{**kw, **EXACT, "pair_capacity": 1 << 15}))


def read_dir(d):
    return {f: read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def assert_renders_close(a_dir, b_dir):
    a, b = read_dir(a_dir), read_dir(b_dir)
    assert list(a) == list(b) and a
    for f in a:
        assert a[f].shape == b[f].shape
        assert np.abs(a[f].astype(int) - b[f].astype(int)).max() <= 1, f


def test_gs_render_and_metrics_match_jax(tmp_path, exact_jax, monkeypatch):
    src = str(tmp_path / "scene")
    s = write_scene(src)
    model = GaussianModel(params_from_numpy({
        "xyz": s["means3d"], "features_dc": s["shs"][:, :1],
        "features_rest": s["shs"][:, 1:], "scaling": np.log(s["scales"]),
        "rotation": s["rotations"],
        "opacity": np.log(s["opacities"] / (1 - s["opacities"]))[:, None]},
        device="cpu"), 3)
    for side in ("port", "jax"):
        model.save_ply(str(tmp_path / side / "point_cloud" / "iteration_7"
                           / "point_cloud.ply"))
    gs_tools.gs_render(str(tmp_path / "port"), src, device="cpu")
    jtools.gs_render(str(tmp_path / "jax"), src)
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            sub = os.path.join(split, "ours_7", kind)
            assert_renders_close(str(tmp_path / "port" / sub),
                                 str(tmp_path / "jax" / sub))
    # Metrics on the same renders: JAX's renders scored by both packages.
    (vgg, lin), _ = write_lpips_weights(str(tmp_path))
    monkeypatch.setenv("GS2MESH_LPIPS_VGG", vgg)
    monkeypatch.setenv("GS2MESH_LPIPS_LIN", lin)
    jtools._lpips_net_cache.clear()
    for m in ("m1", "m2"):
        shutil.copytree(str(tmp_path / "jax" / "test"),
                        str(tmp_path / m / "test"))
    got = gs_tools.gs_metrics([str(tmp_path / "m1")], lpips=True,
                              device="cpu")[str(tmp_path / "m1")]
    want = jtools.gs_metrics([str(tmp_path / "m2")], lpips=True)[
        str(tmp_path / "m2")]
    jtools._lpips_net_cache.clear()
    assert list(got) == list(want) == ["ours_7"]
    g, w = got["ours_7"], want["ours_7"]
    assert list(g) == list(w) == ["SSIM", "PSNR", "LPIPS"]
    for k in ("SSIM", "PSNR"):
        assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
    assert g["LPIPS"] == pytest.approx(w["LPIPS"], rel=2e-4)
    with open(tmp_path / "m1" / "results.json") as f:
        assert json.load(f) == got


def test_lpips_weights_missing_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("GS2MESH_LPIPS_VGG", raising=False)
    img = torch.zeros(3, 8, 8)
    with pytest.raises(FileNotFoundError, match="GS2MESH_LPIPS_VGG"):
        gs_tools._lpips(img, img)


def test_gs_full_eval_matches_jax(tmp_path, exact_jax):
    """4 iterations from the scene's point cloud, checkpoints at 2 and 4:
    the test view rendered at both, scored against JAX's run."""
    src = str(tmp_path / "scene")
    write_scene(src)
    got = gs_tools.gs_full_eval([src], str(tmp_path / "port"),
                                iterations=(2, 4), device="cpu")
    want = jtools.gs_full_eval([src], str(tmp_path / "jax"),
                               iterations=(2, 4))
    (gk, g), = got.items()
    (wk, w), = want.items()
    assert os.path.relpath(gk, str(tmp_path / "port")) == \
        os.path.relpath(wk, str(tmp_path / "jax")) == "scene"
    assert list(g) == list(w) == ["ours_2", "ours_4"]
    for it in (2, 4):
        for kind in ("renders", "gt"):
            sub = os.path.join("scene", "test", f"ours_{it}", kind)
            assert_renders_close(str(tmp_path / "port" / sub),
                                 str(tmp_path / "jax" / sub))
        for k in ("SSIM", "PSNR"):
            assert g[f"ours_{it}"][k] == pytest.approx(
                w[f"ours_{it}"][k], rel=1e-3), (it, k)
    assert not os.path.exists(tmp_path / "port" / "scene" / "train")
