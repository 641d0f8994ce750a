"""The port's orchestration layer (gs2mesh_torch.pipeline: config, strings,
run_single; gs2mesh_torch.sfm; the new core.transforms helpers; the
run_pipeline CLI) against the JAX package's, on the CPU.

The resume passes hand both packages the same scene, GS PLY, left.png,
injected analytic depth and masks, and re-enter run_single with skip_GS and
skip_rendering: the cleaned meshes must have equal faces and vertices within
1e-6 (JAX's TSDF stage is jitted, the port follows JAX's eager arithmetic;
tests/test_torch_tsdf_stage.py holds the stages to the same bound). The
end-to-end test is the torch twin of
tests/test_run_single_e2e.py::test_run_single_end_to_end, with its scene and
its limits (L1 < 0.08 after 150 iterations; cleaned mesh within 0.12 of the
unit sphere).
"""

import dataclasses
import inspect
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gs2mesh_tpu.core import transforms as jtf
from gs2mesh_tpu.pipeline import config as jconfig
from gs2mesh_tpu.pipeline import strings as jstrings
from gs2mesh_tpu.pipeline.run_single import dtu_mask_loader as j_dtu_loader
from gs2mesh_tpu.pipeline.run_single import \
    mobilebrick_mask_loader as j_mb_loader
from gs2mesh_tpu.pipeline.run_single import run_single as j_run_single
from gs2mesh_tpu import sfm as jsfm
from gs2mesh_torch.core import transforms as tf
from gs2mesh_torch.core.ply import read_ply
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.pipeline import config, strings
from gs2mesh_torch.pipeline import run_single as rs
from gs2mesh_torch import sfm
from tests.test_run_single_e2e import (H, N_VIEWS, W, _gt_model,
                                       _synthetic_depth, _write_scene)

torch.set_num_threads(1)

MODEL = "DLNR_Middlebury"


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("dataset", config.DATASETS)
def test_for_dataset_matches_jax(dataset):
    a = config.PipelineArgs.for_dataset(dataset)
    b = jconfig.PipelineArgs.for_dataset(dataset)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]


NO_PAIRS = ("renderer_scene_360", "renderer_save_json", "stereo_warm",
            "TSDF_use_occlusion_mask", "TSDF_use_mask", "TSDF_erode_mask")
STORE_TRUE = ("GS_white_background", "renderer_sort_cameras",
              "TSDF_invert_mask", "skip_video_extraction", "skip_colmap",
              "skip_GS", "skip_rendering", "skip_masking", "skip_TSDF")
ARGVS = {
    "defaults": [],
    "no-pairs": [f"--no-{n}" for n in NO_PAIRS],
    "yes-pairs": [f"--{n}" for n in NO_PAIRS],
    "store-true": [f"--{n}" for n in STORE_TRUE],
    "values": ["--colmap_name", "x", "--experiment_folder_name", "e",
               "--downsample", "2", "--GS_iterations", "7",
               "--GS_save_test_iterations", "3", "7", "--GS_devices", "2",
               "--renderer_baseline_absolute", "0.25",
               "--renderer_baseline_percentage", "3.5",
               "--renderer_folder_name", "r", "--stereo_model",
               "DLNR_SceneFlow", "--stereo_occlusion_threshold", "5",
               "--stereo_shading_eps", "0.01", "--TSDF_scale", "0.5",
               "--TSDF_dilate", "2", "--TSDF_valid", "0,1",
               "--TSDF_skip", "3", "--TSDF_erosion_kernel_size", "4",
               "--TSDF_closing_kernel_size", "6", "--TSDF_voxel", "8",
               "--TSDF_sdf_trunc", "0.1", "--TSDF_min_depth_baselines", "2",
               "--TSDF_max_depth_baselines", "9",
               "--TSDF_cleaning_threshold", "11", "--GS_port", "9000"],
    "last-wins": ["--no-TSDF_use_mask", "--TSDF_use_mask",
                  "--stereo_warm", "--no-stereo_warm"],
}


@pytest.mark.parametrize("dataset", config.DATASETS)
@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parser_matches_jax(dataset, case):
    argv = list(ARGVS[case])
    if dataset == "custom" and case == "values":
        argv += ["--video_extension", "mov", "--video_interval", "3",
                 "--masker_automask", "--masker_prompt", "cup",
                 "--masker_SAM2_local"]
    if dataset != "custom" and case == "values":
        argv += ["--scans", "24", "37"]
    got = vars(config.make_parser(dataset).parse_args(argv))
    want = vars(jconfig.make_parser(dataset).parse_args(argv))
    assert got == want
    # --TSDF_valid / --TSDF_skip stay strings, as in the JAX parser.
    if case == "values":
        assert got["TSDF_valid"] == "0,1" and got["TSDF_skip"] == "3"


def test_encode_string_matches_jax():
    for s in ("", "Barn", "Ignatius", "aston", "space_shuttle", "é∆"):
        assert config.encode_string(s) == jconfig.encode_string(s)
    assert config.DEFAULT_SCANS == jconfig.DEFAULT_SCANS
    assert config.DEFAULT_VALUES == jconfig.DEFAULT_VALUES


# ------------------------------------------------------------------ strings

def _args_grid():
    rng = np.random.default_rng(7)
    for i in range(24):
        dataset = config.DATASETS[i % len(config.DATASETS)]
        kw = dict(
            GS_white_background=bool(rng.integers(2)),
            GS_iterations=int(rng.integers(1, 40000)),
            renderer_baseline_absolute=(None if rng.integers(2) else
                                        float(rng.uniform(0, 2))),
            renderer_baseline_percentage=float(rng.choice([7.0, 14.0, 3.5])),
            TSDF_use_mask=bool(rng.integers(2)),
            TSDF_use_occlusion_mask=bool(rng.integers(2)),
            TSDF_scale=float(rng.choice([1, 0.1, 1.0, 2])),
            TSDF_voxel=int(rng.integers(1, 16)),
            TSDF_min_depth_baselines=int(rng.integers(1, 5)),
            TSDF_max_depth_baselines=int(rng.integers(5, 30)),
            experiment_folder_name=None if rng.integers(2) else f"exp{i}",
            renderer_folder_name=None if rng.integers(2) else f"r{i}",
            colmap_name=f"scan{i}")
        yield dataset, kw


def test_create_strings_matches_jax(tmp_path):
    for dataset, kw in _args_grid():
        a = config.PipelineArgs.for_dataset(dataset, **kw)
        b = jconfig.PipelineArgs.for_dataset(dataset, **kw)
        assert strings.create_strings(a, str(tmp_path)) == \
            jstrings.create_strings(b, str(tmp_path))
    assert strings.CSV_HEADERS == jstrings.CSV_HEADERS
    for x in (1, 0.5, 7.0, 1e-05, "a.b"):
        assert strings.float2str(x) == jstrings.float2str(x)


@pytest.mark.parametrize("dataset", ["DTU", "TNT", "MobileBrick"])
def test_eval_csv_is_byte_identical(tmp_path, monkeypatch, dataset):
    rows = [[24, 0.5, 0.25, 0.375], ["Barn", 1e-3, float("nan"), 2],
            ["aston", 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]]
    files = {}
    for side, cfg, st in (("jax", jconfig, jstrings),
                          ("port", config, strings)):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        args = cfg.PipelineArgs.for_dataset(dataset)
        name, exp_path, csv_file = st.prepare_eval(args, "/elsewhere")
        # The evaluation tree is rooted at the working directory.
        assert exp_path == os.path.join(str(cwd), "evaluation", dataset,
                                        "eval_output", name)
        for row in rows:
            st.write_to_csv(dataset, csv_file, row)
        st.prepare_eval(args, "/elsewhere")      # headers written once
        files[side] = open(csv_file, "rb").read()
    assert files["port"] == files["jax"]
    assert files["port"].count(b"\n") == len(rows) + 1


# --------------------------------------------------------------- transforms

def test_new_transforms_match_jax():
    rng = np.random.default_rng(3)
    from scipy.spatial.transform import Rotation
    R = Rotation.random(5, random_state=3).as_matrix()
    for r in R:
        np.testing.assert_array_equal(tf.matrix_to_quaternion(r),
                                      jtf.matrix_to_quaternion(r))
        q = jtf.matrix_to_quaternion(r)
        np.testing.assert_array_equal(tf.quaternion_to_matrix(q),
                                      jtf.quaternion_to_matrix(q))
        np.testing.assert_array_equal(tf.rotmat2qvec_wxyz(r),
                                      jtf.rotmat2qvec_wxyz(r))
    K = np.array([[70.0, 0, 31.5], [0, 72.0, 23.5], [0, 0, 1]])
    depth = rng.uniform(0.5, 3, (48, 64))
    pts = tf.depth_image_to_point_cloud(depth, K)
    np.testing.assert_array_equal(pts, jtf.depth_image_to_point_cloud(depth,
                                                                      K))
    np.testing.assert_array_equal(tf.project_points_to_image(pts, K),
                                  jtf.project_points_to_image(pts, K))
    np.testing.assert_allclose(tf.project_points_to_image(pts, K)[:64, 0],
                               np.arange(64), atol=1e-9)
    T = rng.normal(size=3)
    np.testing.assert_array_equal(tf.transform_points(pts, R[0], T),
                                  jtf.transform_points(pts, R[0], T))
    sphere = rng.normal(size=(40, 3))
    sphere = 2.5 * sphere / np.linalg.norm(sphere, axis=1, keepdims=True) + T
    # The port's fit starts from the renderer stage's mean (one mean over
    # the rows), JAX's transforms helper from per-axis means: the same
    # optimum within 1e-12 relative.
    for pts in (sphere, sphere[:7], sphere * 3 - 1):
        a, b = tf.sphere_fit_radius(pts), jtf.sphere_fit_radius(pts)
        assert abs(a - b) <= 1e-12 * abs(b)
    assert abs(tf.sphere_fit_radius(sphere) - 2.5) < 1e-6


# ---------------------------------------------------------------- sfm

def _mobilebrick_tree(root):
    rng = np.random.default_rng(5)
    from scipy.spatial.transform import Rotation
    for d in ("pose", "intrinsic", "images"):
        os.makedirs(os.path.join(root, d))
    for i in range(4):
        T = np.eye(4)
        T[:3, :3] = Rotation.random(random_state=i).as_matrix()
        T[:3, 3] = rng.normal(size=3)
        np.savetxt(os.path.join(root, "pose", f"{i:06}.txt"), T)
        K = np.array([[1400 + i, 0, 960.5], [0, 1401.25, 720.25], [0, 0, 1]])
        np.savetxt(os.path.join(root, "intrinsic", f"{i:06}.txt"), K)
        open(os.path.join(root, "images", f"{i:06}.jpg"), "wb").close()


def test_mobile_brick_colmap_files_byte_identical(tmp_path):
    for side, mod in (("jax", jsfm), ("port", sfm)):
        _mobilebrick_tree(str(tmp_path / side))
        mod.create_mobile_brick_colmap_files(str(tmp_path / side), "aston")
    for name in ("images.txt", "cameras.txt", "points3D.txt"):
        a = (tmp_path / "port" / "sparse" / "0" / name).read_bytes()
        b = (tmp_path / "jax" / "sparse" / "0" / name).read_bytes()
        assert a == b, name
    assert (tmp_path / "port" / "sparse" / "0" / "images.txt").stat().st_size


def test_downsampled_dir_close_to_pil(tmp_path):
    """Same file names and sizes as JAX's PIL resize; pixels within 3/255
    of PIL's bicubic on smooth images (PIL rounds its fixed-point filter
    otherwise; the limit is set by 8-bit rounding of two bicubic
    implementations), and the means within 0.5/255."""
    yy, xx = np.mgrid[0:61, 0:83].astype(np.float64)
    base = {"a.png": np.stack([128 + 100 * np.sin(xx / 9),
                               128 + 90 * np.cos(yy / 7),
                               128 + 60 * np.sin((xx + yy) / 11)], -1),
            "b.png": 128 + 100 * np.sin(xx / 5 + yy / 13),
            "c.png": np.concatenate([np.stack(
                [128 + 80 * np.cos(xx / 6)] * 3, -1),
                np.full((61, 83, 1), 255.0)], -1)}
    for side in ("jax", "port"):
        d = tmp_path / side / "scan" / "images"
        d.mkdir(parents=True)
        for name, img in base.items():
            write_png(str(d / name), img.round().astype(np.uint8))
        (d / "notes.txt").write_text("not an image")
    j = jsfm.create_downsampled_colmap_dir(str(tmp_path / "jax" / "scan"), 2)
    p = sfm.create_downsampled_colmap_dir(str(tmp_path / "port" / "scan"), 2)
    assert os.path.basename(p) == os.path.basename(j) == "scan_downsample2"
    assert sorted(os.listdir(os.path.join(p, "images"))) == \
        sorted(os.listdir(os.path.join(j, "images"))) == sorted(base)
    for name in base:
        a = read_png(os.path.join(p, "images", name)).astype(np.int16)
        b = np.asarray(Image.open(os.path.join(j, "images", name)), np.int16)
        assert a.shape == b.shape and a.shape[:2] == (30, 41)
        assert np.abs(a - b).max() <= 3, (name, np.abs(a - b).max())
        assert abs(a.mean() - b.mean()) < 0.5
    # Reused when the counts match, as in JAX.
    assert sfm.create_downsampled_colmap_dir(
        str(tmp_path / "port" / "scan"), 2) == p


def test_downsample_raises_on_non_png(tmp_path):
    d = tmp_path / "scan" / "images"
    d.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(d / "x.jpg"))
    with pytest.raises(ValueError, match="PNG"):
        sfm.create_downsampled_colmap_dir(str(tmp_path / "scan"), 2)


def test_colmap_and_cv2_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))        # no colmap binary
    for mod in (jsfm, sfm):
        for fn in (mod.run_colmap, mod.run_colmap_known_poses):
            with pytest.raises(RuntimeError, match="COLMAP binary not found"):
                fn(str(tmp_path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--skip_video_extraction"):
        sfm.extract_frames(str(tmp_path / "v.mp4"), str(tmp_path / "out"))


# ------------------------------------------------------------ mask loaders

def _mask_pngs(root, w, h, mode, n=2):
    os.makedirs(root)
    rng = np.random.default_rng(w + len(mode))
    for i in range(n):
        m = rng.random((h, w)) < 0.5
        gray = np.where(m, 200 + i, rng.integers(0, 90, (h, w))).astype(
            np.uint8)
        arr = {"L": gray,
               "RGB": np.stack([gray, 255 - gray, gray // 2], -1),
               "RGBA": np.stack([gray, gray, 255 - gray,
                                 np.full_like(gray, 255)], -1)}[mode]
        Image.fromarray(arr, mode).save(os.path.join(root, f"{i:03}.png"))
    if n > 1:     # an all-zero mask: the 1e-9 floor of the division
        Image.fromarray(np.zeros((h, w), np.uint8), "L").convert(mode).save(
            os.path.join(root, f"{n:03}.png"))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("which", ["DTU", "MobileBrick"])
def test_mask_loaders_bit_equal_to_pil(tmp_path, mode, which):
    w, h = (1600, 1200) if which == "DTU" else (64, 48)
    _mask_pngs(str(tmp_path / "mask"), w, h, mode)
    loaders = {"DTU": (rs.dtu_mask_loader, j_dtu_loader),
               "MobileBrick": (rs.mobilebrick_mask_loader, j_mb_loader)}
    port, jax_ = (f(str(tmp_path), None) for f in loaders[which])
    for i in range(3):
        a, b = port(i), jax_(i)
        assert a.dtype == b.dtype == np.bool_
        assert a.shape == b.shape == ((1162, 1554) if which == "DTU"
                                      else (48, 64))
        np.testing.assert_array_equal(a, b)
    assert port(0).any() and not port(2).any()


def test_mask_loader_raises_on_palette_png(tmp_path):
    os.makedirs(tmp_path / "mask")
    Image.fromarray(np.zeros((48, 64), np.uint8), "L").convert("P").save(
        str(tmp_path / "mask" / "000.png"))
    Image.fromarray(np.ones((48, 64), bool)).save(
        str(tmp_path / "mask" / "001.png"))                 # 1-bit
    load = rs.mobilebrick_mask_loader(str(tmp_path), None)
    for i in range(2):
        with pytest.raises(ValueError, match="unsupported PNG"):
            load(i)


# ------------------------------------------------------------ run_single

@pytest.fixture(scope="module")
def scene_tree(tmp_path_factory):
    """tests/test_run_single_e2e.py's scene (COLMAP model, ground-truth
    images written by JAX's renderer, the noisy init cloud) and the GT
    model's PLY, written once."""
    base = str(tmp_path_factory.mktemp("scene"))
    colmap_dir = _write_scene(base)
    ply = os.path.join(base, "gt.ply")
    _gt_model()[0].save_ply(ply)
    return colmap_dir, ply


def _resume_args(cfg_mod, dataset, name):
    args = cfg_mod.PipelineArgs.for_dataset(
        dataset, colmap_name=name, skip_GS=True, skip_rendering=True,
        skip_video_extraction=True, skip_colmap=True, GS_iterations=150,
        TSDF_voxel=16, TSDF_sdf_trunc=0.2, TSDF_cleaning_threshold=10,
        TSDF_erosion_kernel_size=3, TSDF_closing_kernel_size=4)
    if dataset == "custom":
        args.renderer_baseline_absolute = 0.15
        args.TSDF_min_depth_baselines = 1
        args.TSDF_max_depth_baselines = 30
    return args


def _dtu_masks(colmap_dir, cameras):
    """855x651 masks: DTU's principal-point crop of them is the 64x64
    view, which holds the sphere's silhouette; outside the crop noise."""
    os.makedirs(os.path.join(colmap_dir, "mask"))
    rng = np.random.default_rng(1)
    for i, cam in enumerate(cameras):
        m = rng.integers(0, 256, (651, 855)).astype(np.uint8)
        m[587:651, 791:855] = np.where(_synthetic_depth(cam) > 0, 255, 0)
        write_png(os.path.join(colmap_dir, "mask", f"{i:03}.png"), m)


def _stage_resume_tree(base, scene_tree, dataset, name, args):
    """Both packages' inputs: the scene, the GS PLY, left.png, the
    analytic depth and an occlusion mask per view. Returns the port's
    renderer cameras."""
    src, ply = scene_tree
    colmap_dir = os.path.join(base, "data", dataset, name)
    shutil.copytree(src, colmap_dir)
    st = strings.create_strings(args, base)
    model_dir = os.path.join(base, "splatting_output", st["splatting"], name,
                             "point_cloud", "iteration_150")
    os.makedirs(model_dir)
    shutil.copy(ply, os.path.join(model_dir, "point_cloud.ply"))
    r = rs.Renderer(base, colmap_dir, st["output_dir_root"], args,
                    device="cpu")
    rng = np.random.default_rng(4)
    for i, cam in enumerate(r.left_cameras):
        out = os.path.join(r.render_folder_name(i), f"out_{MODEL}")
        os.makedirs(out)
        shutil.copy(os.path.join(colmap_dir, "images", f"{i:03}.png"),
                    os.path.join(r.render_folder_name(i), "left.png"))
        np.save(os.path.join(out, "depth.npy"), _synthetic_depth(cam))
        np.save(os.path.join(out, "occlusion_mask.npy"),
                rng.random((H, W)) > 0.02)
    if dataset == "DTU":
        _dtu_masks(colmap_dir, r.left_cameras)
    return r.left_cameras


@pytest.mark.parametrize("dataset", ["custom", "DTU"])
def test_resume_pass_matches_jax(tmp_path, scene_tree, dataset):
    name = "synth" if dataset == "custom" else "scan1"
    meshes = {}
    for side, cfg_mod, run, kw in (
            ("jax", jconfig, j_run_single, {}),
            ("port", config, rs.run_single, {"device": "cpu"})):
        base = str(tmp_path / side)
        args = _resume_args(cfg_mod, dataset, name)
        _stage_resume_tree(base, scene_tree, dataset, name, args)
        path = run(args, base_dir=base, pair_capacity=1 << 15, **kw)
        assert path == strings.create_strings(args, base)["ply_path"]
        meshes[side] = read_ply(path)
        if dataset == "DTU":
            m = np.load(os.path.join(os.path.dirname(path), "000",
                                     "left_mask.npy"))
            assert m.shape == (H, W) and 0.1 < m.mean() < 0.9
    p, j = meshes["port"], meshes["jax"]
    assert len(p.faces) > 100
    np.testing.assert_array_equal(p.faces, j.faces)
    np.testing.assert_allclose(p.positions, j.positions, rtol=0, atol=1e-6)
    r = np.linalg.norm(p.positions, axis=1)
    assert abs(np.median(r) - 1.0) < 0.12


def test_run_single_end_to_end(tmp_path, scene_tree):
    """Torch twin of test_run_single_e2e.py::test_run_single_end_to_end:
    150 iterations at 64x64 on the CPU, a random DLNR at 1 iteration, TSDF,
    then the skip_GS + skip_rendering re-entry on analytic depth."""
    from gs2mesh_torch.stereo import DLNR, init_dlnr_

    base = str(tmp_path)
    shutil.copytree(scene_tree[0], os.path.join(base, "data", "custom",
                                                "synth"))
    args = config.PipelineArgs.for_dataset("custom")
    args.colmap_name = "synth"
    args.skip_video_extraction = True
    args.skip_colmap = True
    args.skip_masking = True
    args.GS_iterations = 150
    args.GS_save_test_iterations = [150]
    args.renderer_baseline_absolute = 0.15
    args.TSDF_max_depth_baselines = 30
    args.TSDF_min_depth_baselines = 1
    args.TSDF_voxel = 16
    args.TSDF_sdf_trunc = 0.2
    args.TSDF_cleaning_threshold = 10
    args.TSDF_use_mask = False

    dlnr = DLNR()
    init_dlnr_(dlnr, torch.Generator().manual_seed(0))
    mesh_path = rs.run_single(args, base_dir=base, stereo_model=dlnr,
                              pair_capacity=1 << 15, stereo_iters=1,
                              device="cpu")
    assert os.path.exists(mesh_path)

    st = strings.create_strings(args, base)
    model_dir = os.path.join(base, "splatting_output", st["splatting"],
                             "synth")
    assert os.path.exists(os.path.join(model_dir, "point_cloud",
                                       "iteration_150", "point_cloud.ply"))
    assert os.path.exists(os.path.join(model_dir, "chkpnt150.pt"))
    assert not os.path.exists(os.path.join(model_dir, "cfg_args"))
    r = rs.Renderer(base, os.path.join(base, "data", "custom", "synth"),
                    st["output_dir_root"], args, splatting=st["splatting"],
                    device="cpu")
    for i in range(N_VIEWS):
        view_dir = r.render_folder_name(i)
        for f in ("left.png", "right.png"):
            assert os.path.exists(os.path.join(view_dir, f)), f
        out = os.path.join(view_dir, f"out_{args.stereo_model}")
        for f in ("disparity_LR.npy", "depth.npy", "occlusion_mask.npy"):
            assert os.path.exists(os.path.join(out, f)), f

    gt = read_png(os.path.join(base, "data", "custom", "synth", "images",
                               "000.png")).astype(np.float32)
    got = read_png(os.path.join(r.render_folder_name(0),
                                "left.png")).astype(np.float32)
    l1 = np.abs(gt - got).mean() / 255.0
    assert l1 < 0.08, f"GS training did not converge (L1={l1:.3f})"

    for i in range(N_VIEWS):
        out = os.path.join(r.render_folder_name(i),
                           f"out_{args.stereo_model}")
        np.save(os.path.join(out, "depth.npy"),
                _synthetic_depth(r.left_cameras[i]))
        np.save(os.path.join(out, "occlusion_mask.npy"),
                np.ones((H, W), bool))
    args.skip_GS = True
    args.skip_rendering = True
    mesh_path2 = rs.run_single(args, base_dir=base, pair_capacity=1 << 15,
                               device="cpu")
    assert mesh_path2 == mesh_path
    verts = read_ply(mesh_path2).positions
    assert verts.shape[0] > 100
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.12, np.median(radii)
    assert np.mean(np.abs(radii - 1.0)) < 0.12


def test_unported_branches_raise(tmp_path, scene_tree):
    with pytest.raises(NotImplementedError, match="A16"):
        rs.train_gs(scene_tree[0], str(tmp_path), 1, [1], False, devices=2,
                    device="cpu")
    args = _resume_args(config, "custom", "synth")
    _stage_resume_tree(str(tmp_path), scene_tree, "custom", "synth", args)
    args.skip_masking = False
    args.masker_automask = True
    # The automask is ported (tests/test_torch_masker.py); without SAM2
    # weights it raises JAX's ValueError.
    with pytest.raises(ValueError, match="sam2_checkpoint"):
        rs.run_single(args, base_dir=str(tmp_path), device="cpu")


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from gs2mesh_torch.cli import drivers, run_pipeline

    for fn in (rs.run_single, rs.train_gs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = config.PipelineArgs.for_dataset("custom", skip_GS=True)
    with pytest.raises(RuntimeError, match="cuda"):
        rs.run_single(args, base_dir=str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline.main(["single", "--dataset", "DTU", "--skip_GS"])
    with pytest.raises(RuntimeError, match="cuda"):
        drivers.run_MipNerf360(config.PipelineArgs.for_dataset(
            "MipNerf360", scans=["garden"]), base_dir=str(tmp_path))
    assert run_pipeline.main([]) == 2 and run_pipeline.main(["nope"]) == 2


def test_cli_parses_like_jax(monkeypatch):
    """_args_from_cli gives the JAX CLI's PipelineArgs, and `single`
    takes --dataset out of the flags before parsing."""
    from gs2mesh_tpu.cli import run_pipeline as jcli
    from gs2mesh_torch.cli import run_pipeline as cli

    argv = ["--scans", "24", "--skip_GS", "--no-TSDF_use_mask",
            "--GS_iterations", "40"]
    a = cli._args_from_cli("DTU", argv)
    b = jcli._args_from_cli("DTU", argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    seen = {}
    monkeypatch.setattr(rs, "run_single",
                        lambda args: seen.setdefault("args", args) and "p")
    assert cli.main(["single", "--dataset", "MobileBrick", "--skip_GS"]) == 0
    assert seen["args"].dataset == "MobileBrick" and seen["args"].skip_GS
