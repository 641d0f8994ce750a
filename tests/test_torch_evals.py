"""The port's evaluations, native host kernels and dataset drivers
(gs2mesh_torch.evals, .native, .cli.drivers, .cli.preprocess) against the
JAX package's, on the CPU.

The evals are the same numpy/scipy code in both packages, so on identical
inputs they must give identical outputs (exact equality unless a test
states a tolerance). The port decomposes DTU's camera matrices with scipy's
RQ where JAX calls OpenCV: held to cv2.decomposeProjectionMatrix within the
limits in test_load_K_Rt_from_P_matches_cv2. The driver tests run both
packages' run_DTU / run_MobileBrick in resume mode on one tiny synthetic
scan; their meshes differ in the last bits (vertices within 1e-6), so the
CSV rows are held to 1e-3 relative, looser than the evals' own.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import scipy.io
import torch

from gs2mesh_tpu import native as jnative
from gs2mesh_tpu.cli import drivers as jdrivers
from gs2mesh_tpu.evals import dtu as jdtu
from gs2mesh_tpu.evals import geometry as jgeo
from gs2mesh_tpu.evals import mobilebrick as jmb
from gs2mesh_tpu.evals import tnt as jtnt
from gs2mesh_tpu.pipeline import config as jconfig
from gs2mesh_torch import native
from gs2mesh_torch.cli import drivers
from gs2mesh_torch.cli.preprocess import image_size
from gs2mesh_torch.core.ply import write_mesh_ply, write_ply
from gs2mesh_torch.core.png import write_png
from gs2mesh_torch.evals import dtu, mobilebrick as mb
from gs2mesh_torch.evals.geometry import (area_weighted_samples,
                                          icp_point_to_point, nn_distances,
                                          radius_downsample,
                                          sample_mesh_surface, umeyama,
                                          voxel_downsample)
from gs2mesh_torch.evals.mobilebrick import evaluate as mb_evaluate
from gs2mesh_torch.evals.tnt import CropVolume, evaluate_histo
from gs2mesh_torch.pipeline import config, strings
from tests.test_pipeline import _lookat_w2c
from tests.test_run_single_e2e import _synthetic_depth, _views
from tests.test_torch_run_single import _resume_args, _stage_resume_tree
from tests.test_torch_run_single import scene_tree  # noqa: F401 (fixture)

torch.set_num_threads(1)


# -------------------------------------------- twins of tests/test_evals.py

def _unit_quad():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                     np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    return verts, faces


def test_surface_sampling_density():
    verts, faces = _unit_quad()
    pts = sample_mesh_surface(verts, faces, density=0.05)
    assert 200 < len(pts) < 1200
    assert np.all(np.abs(pts[:, 2]) < 1e-9)
    assert np.all((pts[:, :2] >= -1e-9) & (pts[:, :2] <= 1 + 1e-9))


def test_radius_downsample_spacing():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    pts = rng.random((2000, 3))
    down = radius_downsample(pts, radius=0.2, seed=0)
    dd, _ = cKDTree(down).query(down, k=2)
    assert dd[:, 1].min() > 0.2 - 1e-9


def test_voxel_downsample_centroids():
    pts = np.array([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [5.0, 5.0, 5.0]])
    out = voxel_downsample(pts, voxel=1.0)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(sorted(out[:, 0]), [0.15, 5.0])


def _rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0],
                     [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(50, 3))
    s, t = 1.7, np.array([0.3, -0.2, 1.0])
    dst = s * src @ _rot_z(0.7).T + t
    T = umeyama(src, dst, with_scaling=True)
    np.testing.assert_allclose(src @ T[:3, :3].T + T[:3, 3], dst, atol=1e-9)


def test_icp_converges_from_small_offset():
    rng = np.random.default_rng(2)
    dst = rng.normal(size=(500, 3))
    src = (dst - np.array([0.02, -0.01, 0.03])) @ _rot_z(0.05)
    T, fitness, rmse = icp_point_to_point(src, dst, max_corr_dist=0.3,
                                          max_iteration=30)
    got = src @ T[:3, :3].T + T[:3, 3]
    assert fitness > 0.99
    assert np.abs(got - dst).max() < 1e-4


def test_crop_volume_polygon():
    vol = CropVolume(bounding_polygon=[[0, 0, 0], [2, 0, 0], [2, 0, 2],
                                       [0, 0, 2]],
                     orthogonal_axis="Y", axis_min=-1, axis_max=1)
    pts = np.array([[1, 0, 1], [3, 0, 1], [1, 2, 1], [1.9, 0.9, 1.9]])
    assert list(vol.contains(pts)) == [True, False, False, True]


def test_evaluate_histo_perfect_match(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.random((3000, 3))
    vol = CropVolume([[-1, -1, -1], [2, -1, -1], [2, -1, 2], [-1, -1, 2]],
                     "Y", -1, 2)
    p, r, f1, *_ = evaluate_histo(pts, pts, np.eye(4), vol, 0.005, 0.01,
                                  str(tmp_path), 5, "test")
    assert p == pytest.approx(1.0)
    assert r == pytest.approx(1.0)
    assert f1 == pytest.approx(1.0)


def test_mobilebrick_metrics_scale():
    rng = np.random.default_rng(4)
    gt = rng.random((5000, 3))
    pred = gt + 0.001
    out = mb_evaluate(pred, gt, threshold=0.0025)
    assert out["accuracy"] == pytest.approx(1.0)
    assert out["recall"] == pytest.approx(1.0)
    assert out["chamfer"] < 0.005
    assert mb_evaluate(pred, gt, threshold=0.001)["accuracy"] < 1.0


def test_area_weighted_samples_on_quad():
    verts, faces = _unit_quad()
    pts = area_weighted_samples(verts, faces, 1000, seed=0)
    assert pts.shape == (1000, 3)
    assert np.all(np.abs(pts[:, 2]) < 1e-12)
    np.testing.assert_allclose(pts[:, :2].mean(axis=0), [0.5, 0.5],
                               atol=0.05)


# ------------------------------------------- twins of tests/test_native.py

def test_native_radius_downsample_matches_python():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    pts = rng.random((3000, 3)).astype(np.float32)
    nmask = native.greedy_radius_downsample_mask(pts, 0.07)
    tree = cKDTree(pts)
    mask = np.ones(len(pts), dtype=bool)
    for curr, idxs in enumerate(tree.query_ball_point(pts, r=0.07)):
        if mask[curr]:
            mask[idxs] = False
            mask[curr] = True
    np.testing.assert_array_equal(nmask, mask)


def _fans():
    faces, base = [], 0
    for fan in (5, 3, 1):
        for i in range(fan):
            faces.append([base, base + 1 + i, base + 2 + i])
        base += fan + 2
    return np.asarray(faces, np.int32), base


def test_native_triangle_clusters_partition():
    faces, nv = _fans()
    labels, counts = native.triangle_clusters(faces, nv)
    assert counts.sum() == len(faces)
    assert sorted(counts.tolist()) == [1, 3, 5]
    np.testing.assert_array_equal(labels, [0] * 5 + [1] * 3 + [2])


def test_native_nn_sq_distances_grid():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(2)
    ref = rng.random((500, 3)).astype(np.float32)
    query = rng.random((200, 3)).astype(np.float32)
    out = native.nn_sq_distances_grid(ref, query, radius=0.2)
    d, _ = cKDTree(ref).query(query, k=1, distance_upper_bound=0.2)
    want = np.where(np.isfinite(d), d ** 2, np.inf)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-9)


# ------------------------------ native kernels vs their plain versions / JAX

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_kernels_match_plain_and_jax(seed):
    rng = np.random.default_rng(seed)
    pts = (rng.random((4000, 3)) * rng.uniform(0.5, 3)).astype(np.float32)
    radius = float(rng.uniform(0.05, 0.3))
    got = native.greedy_radius_downsample_mask(pts, radius)
    np.testing.assert_array_equal(
        got, native.greedy_radius_downsample_mask_plain(pts, radius))
    np.testing.assert_array_equal(
        got, jnative.greedy_radius_downsample_mask(pts, radius))
    assert 0 < got.sum() < len(pts)

    faces = rng.integers(0, 3000, (1500, 3)).astype(np.int32)
    labels, counts = native.triangle_clusters(faces, 3000)
    plabels, pcounts = native.triangle_clusters_plain(faces, 3000)
    np.testing.assert_array_equal(labels, plabels)
    np.testing.assert_array_equal(counts, pcounts)
    jl, jc = jnative.triangle_clusters(faces, 3000)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(counts, jc)

    query = (rng.random((800, 3)) * 3).astype(np.float32)
    d2 = native.nn_sq_distances_grid(pts, query, radius)
    # The same float32 coordinates in float64 arithmetic; scipy takes a
    # square root and the test squares it again (a few ulps).
    np.testing.assert_allclose(
        d2, native.nn_sq_distances_grid_plain(pts, query, radius),
        rtol=1e-12, atol=0)
    np.testing.assert_array_equal(
        d2, jnative.nn_sq_distances_grid(pts, query, radius))
    assert np.isinf(d2).any() and np.isfinite(d2).any()


def test_native_build_raises_without_fallback(tmp_path, monkeypatch):
    bad = tmp_path / "geom_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.greedy_radius_downsample_mask(np.zeros((3, 3)), 0.1)
    with pytest.raises(RuntimeError):
        radius_downsample(np.zeros((3, 3)), 0.1)
    assert not any((tmp_path / "build").glob("*.so"))


# ------------------------------------------------- evals vs JAX, same inputs

def uv_sphere(n_lat=24, n_lon=48, radius=1.0, center=(0, 0, 0)):
    """Latitude-longitude triangulation of a sphere: (V, 3), (F, 3)."""
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                    -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]])
    faces = []
    for j in range(n_lon):
        k = (j + 1) % n_lon
        faces.append([0, 1 + k, 1 + j])
        last = 1 + (n_lat - 2) * n_lon
        faces.append([len(verts) - 1, last + j, last + k])
        for i in range(n_lat - 2):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + k
            faces += [[a, b, a + n_lon], [b, b + n_lon, a + n_lon]]
    return verts * radius + np.asarray(center), np.asarray(faces, np.int64)


def test_geometry_matches_jax():
    rng = np.random.default_rng(11)
    verts, faces = uv_sphere()
    verts = verts + rng.normal(scale=0.01, size=verts.shape)
    for density in (0.02, 0.05, 0.3):
        np.testing.assert_array_equal(
            sample_mesh_surface(verts, faces, density),
            jgeo.sample_mesh_surface(verts, faces, density))
    for seed in (0, 3):
        np.testing.assert_array_equal(
            area_weighted_samples(verts, faces, 5000, seed=seed),
            jgeo.area_weighted_samples(verts, faces, 5000, seed=seed))
    pts = rng.random((6000, 3)) * 2
    for seed, r in ((0, 0.05), (5, 0.2)):
        np.testing.assert_array_equal(
            radius_downsample(pts, r, seed=seed),
            jgeo.radius_downsample(pts, r, seed=seed))
    np.testing.assert_array_equal(voxel_downsample(pts, 0.1),
                                  jgeo.voxel_downsample(pts, 0.1))
    q = rng.random((3000, 3)) * 2
    np.testing.assert_array_equal(nn_distances(q, pts),
                                  jgeo.nn_distances(q, pts))
    src = rng.normal(size=(80, 3))
    dst = 1.3 * src @ _rot_z(0.4).T + 0.2
    for scaling in (True, False):
        np.testing.assert_array_equal(umeyama(src, dst, scaling),
                                      jgeo.umeyama(src, dst, scaling))
    dst = rng.normal(size=(700, 3))
    src = (dst - 0.02) @ _rot_z(0.03)
    a = icp_point_to_point(src, dst, 0.3, max_iteration=15)
    b = jgeo.icp_point_to_point(src, dst, 0.3, max_iteration=15)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def test_tnt_evals_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    poly = [[-1, 0, -1], [2, 0, -1], [2.5, 0, 1], [0.5, 0, 2.2], [-1, 0, 2]]
    pts = rng.random((5000, 3)) * 4 - 1
    for axis in ("X", "Y", "Z"):
        args = (poly, axis, -0.5, 1.5)
        np.testing.assert_array_equal(CropVolume(*args).contains(pts),
                                      jtnt.CropVolume(*args).contains(pts))
    vol = CropVolume(poly, "Y", -1, 3)
    jvol = jtnt.CropVolume(poly, "Y", -1, 3)
    src = rng.random((4000, 3)) * 2
    tgt = src + rng.normal(scale=0.004, size=src.shape)
    T = np.eye(4)
    T[:3, 3] = [0.001, 0, -0.002]
    a = evaluate_histo(src, tgt, T, vol, 0.005, 0.01, str(tmp_path / "p"),
                       5, "s")
    b = jtnt.evaluate_histo(src, tgt, T, jvol, 0.005, 0.01,
                            str(tmp_path / "j"), 5, "s")
    assert a[:3] == b[:3] and 0 < a[0] < 1
    for x, y in zip(a[3:], b[3:]):
        np.testing.assert_array_equal(x, y)
    for name in ("s.recall.txt", "s.precision.txt", "s.prf_tau_plotstr.txt"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def _mobilebrick_gt(gt_dir):
    os.makedirs(os.path.join(gt_dir, "mesh"), exist_ok=True)
    gv, gf = uv_sphere(32, 64)
    write_mesh_ply(os.path.join(gt_dir, "mesh", "gt_mesh.ply"),
                   gv.astype(np.float32), gf.astype(np.int32))
    res = np.array([61, 61, 61])
    mask = np.ones(res, bool)
    mask[:, :, 40:] = False                     # hide the z > 0.5 cap
    np.save(os.path.join(gt_dir, "visibility_mask.npy"),
            {"resolutions": res, "mask": mask.reshape(-1),
             "voxel_size": 0.05, "min_pts": np.array([-1.5, -1.5, -1.5])},
            allow_pickle=True)


def test_mobilebrick_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    pred = rng.random((3000, 3))
    gt = pred + rng.normal(scale=0.003, size=pred.shape)
    for th in (0.0025, 0.005):
        assert mb.evaluate(pred, gt, th) == jmb.evaluate(pred, gt, th)
    gt_dir = str(tmp_path / "gt")
    _mobilebrick_gt(gt_dir)
    pv, pf = uv_sphere(20, 40, radius=1.003)
    pv = pv @ _rot_z(0.004).T + 0.002
    pred_path = str(tmp_path / "pred.ply")
    write_mesh_ply(pred_path, pv.astype(np.float32), pf.astype(np.int32))
    a = mb.evaluate_single(gt_dir, pred_path, str(tmp_path / "p"), "aston")
    b = jmb.evaluate_single(gt_dir, pred_path, str(tmp_path / "j"), "aston")
    assert a == b and len(a) == 7 and all(np.isfinite(a))
    assert (tmp_path / "p" / "aston_cropped.ply").read_bytes() == \
        (tmp_path / "j" / "aston_cropped.ply").read_bytes()


# ------------------------------------------------------------------- DTU

def test_load_K_Rt_from_P_matches_cv2():
    """K within 1e-9 of cv2's relative to its largest entry, the rotation
    within 1e-12, the camera centre within 1e-6 of its norm (cv2 returns
    the homogeneous centre in float32); the pose is float32 in both."""
    import cv2
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(21)
    for i in range(20):
        K = np.array([[rng.uniform(1500, 3000), rng.uniform(-5, 5),
                       rng.uniform(700, 900)],
                      [0, rng.uniform(1500, 3000), rng.uniform(500, 700)],
                      [0, 0, 1]])
        R = Rotation.random(random_state=i).as_matrix()
        t = rng.normal(size=3) * rng.uniform(1, 500)
        P = (rng.uniform(0.1, 10) * K @ np.hstack([R, t[:, None]])).astype(
            np.float32)
        intr, pose = dtu.load_K_Rt_from_P(P)
        Kc, Rc, tc = cv2.decomposeProjectionMatrix(P)[:3]
        Kc = Kc / Kc[2, 2]
        assert np.abs(intr[:3, :3] - Kc).max() <= 1e-9 * np.abs(Kc).max()
        assert intr[3, 3] == 1 and not intr[3, :3].any()
        assert pose.dtype == np.float32
        np.testing.assert_allclose(pose[:3, :3], Rc.T.astype(np.float32),
                                   rtol=0, atol=1e-12 + 6e-8)
        centre = (tc[:3] / tc[3])[:, 0]
        assert np.abs(pose[:3, 3] - centre).max() <= \
            1e-6 * np.linalg.norm(centre)
        _, Rq, C = dtu.decompose_projection_matrix(P)
        assert np.abs(Rq - Rc).max() < 1e-12
        assert abs(np.linalg.det(Rq) - 1) < 1e-12


SCAN = 7
S_MM = 20.0                                   # the sphere's radius in mm
C_MM = np.array([12.0, -5.0, 400.0])          # its centre in mm
FULL_K = np.array([[70.0, 0, 823.0], [0, 70.0, 619.0], [0, 0, 1]])


def _dtu_cameras():
    return [dict(pos=eye, cx=32.0, cy=32.0, fx=70.0, fy=70.0)
            for eye in _views()]


def write_dtu_layout(dtu_dir, cameras, images=True):
    """DTU's layout for one scan around the unit sphere, which is a sphere
    of S_MM mm at C_MM in the world frame: cameras.npz (world_mat_i from
    each camera's K and pose, scale_mat_i), 855x651 masks whose principal-
    point crop is the 64x64 view's silhouette (cull_scan samples them at
    the full frame's pixels: every vertex here projects inside them),
    ObsMask / Plane .mat files and the stl points of the sphere."""
    scan_dir = os.path.join(dtu_dir, f"scan{SCAN}")
    os.makedirs(os.path.join(scan_dir, "mask"), exist_ok=True)
    if images:
        os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= S_MM
    scale_mat[:3, 3] = C_MM
    mats = {}
    for i, cam in enumerate(cameras):
        R, t = _lookat_w2c(cam["pos"])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = S_MM * t - R @ C_MM
        K4 = np.eye(4)
        K4[:3, :3] = FULL_K
        mats[f"world_mat_{i}"] = K4 @ w2c
        mats[f"scale_mat_{i}"] = scale_mat
        m = np.zeros((651, 855), np.uint8)
        m[587:651, 791:855] = np.where(_synthetic_depth(cam) > 0, 255, 0)
        write_png(os.path.join(scan_dir, "mask", f"{i:03}.png"), m)
        if images:
            write_png(os.path.join(scan_dir, "images", f"{i:03}.png"),
                      np.zeros((64, 64, 3), np.uint8))
    np.savez(os.path.join(scan_dir, "cameras.npz"), **mats)

    mvs = os.path.join(dtu_dir, "SampleSet", "MVS_Data")
    os.makedirs(os.path.join(mvs, "ObsMask"))
    obs = np.ones((56, 56, 56), np.uint8)
    obs[:, :, :20] = 0                            # unobserved slab
    scipy.io.savemat(os.path.join(mvs, "ObsMask", f"ObsMask{SCAN}_10.mat"),
                     {"ObsMask": obs,
                      "BB": np.stack([C_MM - 27.5, C_MM + 27.5]),
                      "Res": np.array([[1.0]])})
    scipy.io.savemat(os.path.join(mvs, "ObsMask", f"Plane{SCAN}.mat"),
                     {"P": np.array([[0.0], [-1.0], [0.0], [C_MM[1] + 15]])})
    n = 20000
    k = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * k / n)
    theta = np.pi * (1 + 5 ** 0.5) * k
    stl = S_MM * np.stack([np.cos(theta) * np.sin(phi),
                           np.sin(theta) * np.sin(phi), np.cos(phi)], -1) \
        + C_MM
    write_ply(os.path.join(mvs, "Points", "stl", f"stl{SCAN:03}_total.ply"),
              {"x": stl[:, 0].astype(np.float32),
               "y": stl[:, 1].astype(np.float32),
               "z": stl[:, 2].astype(np.float32)})
    return scan_dir, mvs


def test_cull_scan_and_dtu_eval_match_jax(tmp_path):
    write_dtu_layout(str(tmp_path), _dtu_cameras())
    rng = np.random.default_rng(31)
    v, f = uv_sphere(40, 80)
    v = v * (1 + rng.normal(scale=0.01, size=(len(v), 1)))
    # a blob beside the sphere (image rows above it in every view),
    # outside every dilated silhouette: culled
    v2, f2 = uv_sphere(6, 12, radius=0.1, center=(0.0, -3.5, 0.0))
    verts = np.concatenate([v, v2])
    faces = np.concatenate([f, f2 + len(v)])
    pv, pf = dtu.cull_scan(SCAN, verts, faces, str(tmp_path))
    jv, jf = jdtu.cull_scan(SCAN, verts, faces, str(tmp_path))
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pv, jv)
    assert len(pv) == len(v) and len(pf) == len(f)    # the blob alone went
    np.testing.assert_allclose(np.linalg.norm(pv - C_MM, axis=1).mean(),
                               S_MM, rtol=0.02)

    mvs = os.path.join(str(tmp_path), "SampleSet", "MVS_Data")
    a = dtu.dtu_eval(pv, pf, SCAN, mvs, str(tmp_path / "p"))
    b = jdtu.dtu_eval(jv, jf, SCAN, mvs, str(tmp_path / "j"))
    for k in ("mean_d2s", "mean_s2d", "overall"):
        assert abs(a[k] - b[k]) <= 1e-9 * abs(b[k]), k
        assert 0 < a[k] < 1.0
    for name in (f"vis_{SCAN:03}_d2s.ply", f"vis_{SCAN:03}_s2d.ply",
                 "results.json"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


# ------------------------------------------------------------- drivers

def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_rows_close(a, b, rel=1e-3):
    assert len(a) == len(b) and a[0] == b[0]
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[0] == rb[0]
        for x, y in zip(ra[1:], rb[1:]):
            x, y = float(x), float(y)
            assert np.isfinite(x) and abs(x - y) <= rel * abs(y) + 1e-12, \
                (ra, rb)


@pytest.mark.parametrize("dataset", ["DTU", "MobileBrick"])
def test_driver_resume_matches_jax(tmp_path, monkeypatch, scene_tree,
                                   dataset):
    name = f"scan{SCAN}" if dataset == "DTU" else "aston"
    rows = {}
    for side, cfg_mod, drv, kw in (("jax", jconfig, jdrivers, {}),
                                   ("port", config, drivers,
                                    {"device": "cpu"})):
        base = str(tmp_path / side)
        args = _resume_args(cfg_mod, dataset, name)
        args.scans = [SCAN] if dataset == "DTU" else [name]
        args.TSDF_scale = 1.0
        cams = _stage_resume_tree(base, scene_tree, dataset, name, args)
        gt_dir = os.path.join(base, "data", dataset, name)
        if dataset == "DTU":
            shutil.rmtree(os.path.join(gt_dir, "mask"))
            write_dtu_layout(os.path.join(base, "data", "DTU"), cams,
                             images=False)
        else:
            os.makedirs(os.path.join(gt_dir, "mask"))
            for i, cam in enumerate(cams):
                write_png(os.path.join(gt_dir, "mask", f"{i:03}.png"),
                          np.where(_synthetic_depth(cam) > 0, 255,
                                   0).astype(np.uint8))
            _mobilebrick_gt(gt_dir)
        monkeypatch.chdir(base)
        run = drv.run_DTU if dataset == "DTU" else drv.run_MobileBrick
        run(args, base_dir=base, **kw)
        _, exp_path, csv_file = strings.prepare_eval(args, base)
        rows[side] = _csv_rows(csv_file)
        assert len(rows[side]) == 2
    _assert_rows_close(rows["port"], rows["jax"])
    if dataset == "DTU":
        d2s, s2d = (float(x) for x in rows["port"][1][1:3])
        assert d2s < 1.0 and s2d < 2.0       # mm, against a 20 mm sphere


def test_image_size_reads_headers(tmp_path):
    from PIL import Image

    img = Image.fromarray(np.zeros((37, 53, 3), np.uint8))
    for name, kw in (("a.png", {}), ("b.jpg", {}),
                     ("c.jpg", {"progressive": True})):
        img.save(str(tmp_path / name), **kw)
        assert image_size(str(tmp_path / name)) == (53, 37)
    (tmp_path / "d.txt").write_text("no image")
    with pytest.raises(ValueError):
        image_size(str(tmp_path / "d.txt"))
