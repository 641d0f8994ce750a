"""Parity of the PyTorch port's core modules (camera, SH, transforms, PLY,
COLMAP text IO, model parameters) with the JAX package, on the CPU."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.core import colmap_io as jcolmap
from gs2mesh_tpu.core import transforms as jtf
from gs2mesh_tpu.core.camera import camera_from_euler as j_camera_from_euler
from gs2mesh_tpu.core.camera import make_camera as j_make_camera
from gs2mesh_tpu.core.sh import eval_sh as j_eval_sh
from gs2mesh_tpu.models.gaussians import (GaussianModel as JModel,
                                          GaussianParams as JParams,
                                          GaussianState as JState)
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core import transforms as tf
from gs2mesh_torch.core.camera import (camera_from_euler, focal2fov,
                                       fov2focal, make_camera)
from gs2mesh_torch.core.sh import eval_sh, rgb_to_sh_dc
from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
from tests.scenes import sphere_scene

torch.set_num_threads(1)

CAMERA_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx",
                 "tan_fovy", "focal_x", "focal_y")


def look_at_camera(eye, width, height, fov_deg=60.0):
    """Port twin of tests.scenes.look_at_camera (same numpy pose math)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    Rw2v = np.stack([right, np.cross(fwd, right), fwd], axis=0)
    fov = math.radians(fov_deg)
    return make_camera(Rw2v.T, -Rw2v @ eye, fov, fov, width, height,
                       device="cpu")


def assert_camera_close(cam, jcam, tol=1e-6):
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)),
                                   rtol=tol, atol=tol, err_msg=f)


def test_make_camera_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        rot = rng.uniform(-60, 60, size=3)
        pos = rng.uniform(-3, 3, size=3)
        R, T = jtf.convert_R_T_to_GS(rot, pos)
        fovx, fovy = rng.uniform(0.5, 1.5, size=2)
        w, h = int(rng.integers(32, 1000)), int(rng.integers(32, 1000))
        assert_camera_close(make_camera(R, T, fovx, fovy, w, h, device="cpu"),
                            j_make_camera(R, T, fovx, fovy, w, h))


def test_camera_from_euler_matches_jax():
    args = ((12.0, -30.0, 5.0), (0.4, -1.2, 2.5), 500.0, 480.0, 640, 480)
    assert_camera_close(camera_from_euler(*args, device="cpu"),
                        j_camera_from_euler(*args))
    assert focal2fov(fov2focal(1.1, 640), 640) == pytest.approx(1.1)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(257, 16, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    got = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy()
    ref = np.asarray(j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        rgb_to_sh_dc(torch.from_numpy(rgb)).numpy(),
        np.asarray((jnp.asarray(rgb) - 0.5) / 0.28209479177387814))


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        rot = rng.uniform(-80, 80, size=3)
        pos = rng.uniform(-2, 2, size=3)
        np.testing.assert_array_equal(tf.eul2rotm(rot), jtf.eul2rotm(rot))
        R = tf.eul2rotm(rot)
        np.testing.assert_array_equal(tf.rotm2eul(R), jtf.rotm2eul(R))
        for a, b in zip(tf.convert_R_T_to_GS(rot, pos),
                        jtf.convert_R_T_to_GS(rot, pos)):
            np.testing.assert_array_equal(a, b)
        assert (tf.calculate_right_camera_pose(rot, pos, 0.3)
                == jtf.calculate_right_camera_pose(rot, pos, 0.3))
        np.testing.assert_array_equal(tf.RT_from_rot_pos(rot, pos),
                                      jtf.RT_from_rot_pos(rot, pos))
        q = jtf.rotmat2qvec_wxyz(R)
        np.testing.assert_array_equal(tf.rotmat2qvec_wxyz(R), q)
        np.testing.assert_array_equal(tf.qvec2rotmat_wxyz(q),
                                      jtf.qvec2rotmat_wxyz(q))
    p = {"fx": 500.0, "fy": 510.0, "cx": 320.0, "cy": 240.0}
    np.testing.assert_array_equal(tf.intrinsic_from_camera_params(p),
                                  jtf.intrinsic_from_camera_params(p))


def _jax_model(sh_degree, n=300):
    s = sphere_scene(n=n, sh_degree=sh_degree, seed=4)
    K = (sh_degree + 1) ** 2
    op = s["opacities"][:, None]
    params = JParams(
        xyz=jnp.asarray(s["means3d"]),
        features_dc=jnp.asarray(s["shs"][:, :1, :]),
        features_rest=jnp.asarray(s["shs"][:, 1:K, :]),
        scaling=jnp.log(jnp.asarray(s["scales"])),
        rotation=jnp.asarray(s["rotations"]),
        opacity=jnp.asarray(np.log(op / (1.0 - op)).astype(np.float32)))
    z = jnp.zeros((n,), jnp.float32)
    return JModel(params=params,
                  state=JState(alive=jnp.ones((n,), bool), max_radii2D=z,
                               xyz_grad_accum=z, denom=z),
                  max_sh_degree=sh_degree)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_roundtrip_both_ways(tmp_path, sh_degree):
    jm = _jax_model(sh_degree)
    jpath, tpath = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jm.save_ply(jpath)
    m = GaussianModel.load_ply(jpath, max_sh_degree=sh_degree, device="cpu")
    for k in m.params.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(m.params, k).numpy(),
                                      np.asarray(getattr(jm.params, k)))
    m.save_ply(tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    back = JModel.load_ply(tpath, max_sh_degree=sh_degree)
    n = m.params.xyz.shape[0]
    for k in m.params.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(back.params, k))[:n],
                                      getattr(m.params, k).numpy())


def test_params_from_numpy_and_activations():
    jm = _jax_model(3)
    jp = {k: np.asarray(v) for k, v in jm.params._asdict().items()}
    m = GaussianModel(params=params_from_numpy(jp, device="cpu"),
                      max_sh_degree=3)
    ref = jm.raster_inputs()
    got = m.raster_inputs()
    for k in ("means3d", "scales", "rotations", "opacities", "shs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    alive = torch.arange(300) % 3 > 0
    m.alive = alive
    assert np.all(m.raster_inputs()["opacities"].numpy()[~alive.numpy()] == 0)


def test_colmap_text_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", 640, 480,
                                    np.array([500.0, 510.0, 320.0, 240.0])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_RADIAL", 320, 200,
                                    np.array([300.0, 160.0, 100.0, 0.01]))}
    imgs = {}
    for i in (1, 2, 3):
        q = rng.normal(size=4)
        imgs[i] = jcolmap.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"{i:03}.png", rng.uniform(0, 100, size=(i, 2)),
            np.arange(i, dtype=np.int64) - 1)
    pts = {7: jcolmap.ColmapPoint3D(7, rng.normal(size=3),
                                    np.array([10, 20, 30]), 0.5,
                                    np.array([1, 2]), np.array([0, 1]))}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcolmap.write_model_text(jdir, cams, imgs, pts)
    tcams = {k: colmap_io.ColmapCamera(**vars(v)) for k, v in cams.items()}
    timgs = {k: colmap_io.ColmapImage(**vars(v)) for k, v in imgs.items()}
    tpts = {k: colmap_io.ColmapPoint3D(**vars(v)) for k, v in pts.items()}
    colmap_io.write_model_text(tdir, tcams, timgs, tpts)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(jdir, f)) as a, \
                open(os.path.join(tdir, f)) as b:
            assert a.read() == b.read(), f

    for reader in ("read_cameras_text", "read_images_text",
                   "read_points3D_text"):
        name = {"read_cameras_text": "cameras.txt",
                "read_images_text": "images.txt",
                "read_points3D_text": "points3D.txt"}[reader]
        got = getattr(colmap_io, reader)(os.path.join(jdir, name))
        ref = getattr(jcolmap, reader)(os.path.join(jdir, name))
        assert got.keys() == ref.keys()
        for k in got:
            for field, v in vars(ref[k]).items():
                np.testing.assert_array_equal(getattr(got[k], field), v)
    np.testing.assert_array_equal(
        colmap_io.poses_from_model(colmap_io.read_images_text(
            os.path.join(jdir, "images.txt"))),
        jcolmap.poses_from_model(imgs))
