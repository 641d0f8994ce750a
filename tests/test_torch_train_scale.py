"""tools/train_scale_torch.py on the CPU (plain versions of kernels K1-K4).

- The scene's arrays are deterministic from the seed, and its splats are
  flat and tangent to their surface.
- At 64x48, with a 3,000-splat ground truth and 60 iterations (pair
  capacity 1 << 15): the binary COLMAP model and the PNGs the tool writes
  read back through load_colmap_scene (the training views only, their
  poses, 60 degrees across the width, the points); the tool's trained PLY
  equals pipeline.run_single.train_gs's on the same files byte for byte;
  the report carries every field the tool records.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.ops.rasterizer.preprocess import quat_to_rotmat
from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.run_single import train_gs
from gs2mesh_torch.train.scene import load_colmap_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import train_scale_torch as ts  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(n_gauss=3000, width=64, height=48, pair_capacity=1 << 15)
ITERS = 60


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_scale"))
    tr, res = ts.run(ITERS, "cpu", root=root, **SMALL)
    return root, tr, res


def test_scene_arrays_deterministic():
    a, b = ts.ground_truth(4000, seed=0), ts.ground_truth(4000, seed=0)
    c = ts.ground_truth(4000, seed=1)
    assert sorted(a) == ["means3d", "opacities", "rgb", "rotations", "scales",
                         "shs"]
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert not np.array_equal(a[k], c[k]), k
    assert a["shs"].shape == (4000, 1, 3)
    assert (a["opacities"] >= 0.7).all() and (a["opacities"] <= 0.99).all()
    px = a["scales"][:, :2] * ts.focal(ts.W) / ts.DISTANCE
    assert (px >= 1 - 1e-4).all() and (px <= 4 + 1e-4).all()
    np.testing.assert_array_equal(a["scales"][:, 2], np.float32(ts.FLAT))
    # The third axis of every splat is its surface's normal.
    normal = quat_to_rotmat(torch.from_numpy(a["rotations"]))[:, :, 2]
    m = a["means3d"]
    on_sphere = np.abs(np.linalg.norm(m, axis=1) - 1) < 1e-5
    on_plane = np.abs(m[:, 1] - ts.PLANE_Y) < 1e-6
    assert (on_sphere ^ on_plane).all()
    np.testing.assert_allclose(normal[on_sphere], m[on_sphere], atol=1e-6)
    np.testing.assert_allclose(normal[on_plane],
                               np.tile([0, 1.0, 0], (on_plane.sum(), 1)),
                               atol=1e-6)


def test_scene_reads_back(tool_run):
    root, _, res = tool_run
    scene = load_colmap_scene(root, device="cpu")
    assert len(scene.cameras) == 64 == sum(n for _, n in ts.RINGS)
    for i, (cam, eye) in enumerate(zip(scene.cameras, ts.train_eyes())):
        ref = ts.camera(eye, SMALL["width"], SMALL["height"], "cpu")
        for f in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(cam, f), getattr(ref, f),
                                       atol=1e-5, err_msg=f"{i} {f}")
        assert abs(cam.tan_fovx - np.tan(np.radians(30))) < 1e-6
        png = read_png(os.path.join(root, "images", f"{i:03}.png"))
        np.testing.assert_array_equal(
            np.round(scene.images[i] * 255).astype(np.uint8),
            png.transpose(2, 0, 1))
    assert len(os.listdir(os.path.join(root, "heldout"))) == 8
    assert scene.points.shape == (3000, 3) == (res["alive_start"], 3)
    assert abs(scene.nerf_norm_radius - res["scene_extent"]) < 1e-6
    gt = ts.ground_truth(3000)
    # 1% jitter of the extent about ground-truth centres.
    d = np.linalg.norm(scene.points[:, None] - gt["means3d"][None], axis=2)
    assert np.median(d.min(1)) < 0.05 * res["scene_extent"]


def test_trained_ply_equals_train_gs(tool_run, tmp_path):
    root, tr, _ = tool_run
    train_gs(root, str(tmp_path), ITERS,
             PipelineArgs().GS_save_test_iterations, False,
             pair_capacity=SMALL["pair_capacity"], device="cpu")
    name = os.path.join("point_cloud", f"iteration_{ITERS}",
                        "point_cloud.ply")
    with open(os.path.join(root, "model", name), "rb") as f:
        tool = f.read()
    with open(os.path.join(tmp_path, name), "rb") as f:
        stage = f.read()
    assert tool == stage
    assert tr.iteration == ITERS


def test_report_fields(tool_run):
    _, tr, res = tool_run
    for k in ("iterations", "scene_s", "setup_s", "gt_pairs", "alive_start",
              "first_loss_mean", "last_loss_mean", "alive_final", "alive_at",
              "params_finite", "pair_capacity_final", "model_capacity_final",
              "heldout_psnr_db", "renders", "reset_alive",
              "trained_vs_plain_max_abs_err", "wall_s", "taken_steps",
              "step_ms_windows", "densifies", "growths",
              "over_capacity_steps", "launches", "peak_memory_gib"):
        assert k in res, k
    assert res["device"] == "cpu" and res["taken_steps"] == ITERS
    assert len(res["gt_pairs"]["images"]) == 64
    assert len(res["gt_pairs"]["heldout"]) == 8
    assert res["alive_at"] == {ITERS: tr.num_alive()}
    assert set(res["heldout_psnr_db"]) == {ITERS}
    assert np.isfinite(res["heldout_psnr_db"][ITERS])
    for view in ("train_view_0", "bench_camera"):
        r = res["renders"][view]
        assert r["pairs"] > 0 and r["render_ms_median"] > 0
        assert r["pairs_per_pixel"] == r["pairs"] / (64 * 48)
    (w,) = res["step_ms_windows"]
    assert w["iterations"] == [1, ITERS]
    for k in ("median_ms", "device_busy_ms", "device_events", "idle_share",
              "alive_end", "median_pairs", "peak_memory_gib"):
        assert k in w, k
    # Device numbers are the card's: none on the CPU.
    assert w["device_busy_ms"] is None and res["peak_memory_gib"] is None
    assert res["trained_vs_plain_max_abs_err"] is None
    assert res["params_finite"]


def test_alive_checks():
    dens = [dict(iteration=i, alive_after=n) for i, n in (
        (2900, 90), (3000, 100), (3100, 60), (3200, 40), (5900, 70),
        (6000, 80), (6100, 90))]
    assert ts.alive_checks(dens, 3000) == [(3000, 100, 40), (6000, 80, 90)]


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        ts.main(1)
