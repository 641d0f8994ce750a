"""The port's sustained-training tools (tools/trainsmoke_chip_torch.py and
tools/calibrate_scene_torch.py) against the JAX tools and package, on the
CPU (plain versions of kernels K1-K4).

- Scenes and cameras: bit-equal to tests/scenes.py, to the numpy the JAX
  tools hand to make_camera (captured by running the JAX tools' own main()
  up to their first render) and to __graft_entry__._scene.
- Golden targets: within 2e-5 of JAX's render_golden in exact carry.
- A whole run at tiny size (3 views at 64x48, a 60-row init, densify at 15
  and 30): the view order equal to JAX's Trainer, every loss before the
  first densify within 1e-4 relative of JAX's (exact carry, impl="xla"),
  the first densify's clone / split / prune counts equal to JAX's except
  for rows whose statistic lies within 1e-4 relative of its threshold.
  After it the two runs draw their split samples from different
  generators (jax.random against a torch generator), so only the tool's
  own checks apply.
- The forced-growth run of chip_smoke.py's phase 19 (b) at tiny size:
  both the model capacity and the pair capacity grow, an overflowed step
  is redone, the parameters stay finite.
"""

import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.core import camera as jcamera
from gs2mesh_tpu.models import gaussians as jg
from gs2mesh_tpu.ops import rasterizer as jrasterizer
from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from gs2mesh_tpu.ops.rasterizer import golden as jgolden
from gs2mesh_tpu.train import trainer as jt
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.train.trainer import TrainConfig, Trainer
from tests.scenes import sphere_scene as j_sphere_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import calibrate_scene_torch as calib  # noqa: E402
import trainsmoke_chip_torch as smoke  # noqa: E402

torch.set_num_threads(1)

EXACT = dict(feat_carry_bf16=False, grad_carry_bf16=False)
CAMERA_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx",
                 "tan_fovy")


class _Stop(Exception):
    pass


def _stop(*a, **kw):
    raise _Stop


def jax_tool_cameras(monkeypatch, name):
    """The make_camera arguments of tools/<name>.py's main(), run up to its
    first render."""
    calls = []
    real = jcamera.make_camera

    def record(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(jcamera, "make_camera", record)
    monkeypatch.setattr(jgolden, "render_golden", _stop)
    monkeypatch.setattr(jrasterizer, "rasterize", _stop)
    monkeypatch.setattr(sys, "argv", [name])
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Stop):
        mod.main()
    return calls


def assert_camera_equal(port, jax_cam):
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_cam, f)),
                                      err_msg=f)
    assert (port.width, port.height) == (jax_cam.width, jax_cam.height)


def assert_pose_call(call, R, T, fov, size):
    jR, jT, fx, fy, w, h = call
    np.testing.assert_array_equal(jR, R)
    np.testing.assert_array_equal(jT, T)
    assert (fx, fy, w, h) == (fov[0], fov[1]) + size


@pytest.mark.parametrize("n,seed,sh", [(4000, 2, 0), (300, 7, 1)])
def test_sphere_scene_bit_equal(n, seed, sh):
    ours = smoke.sphere_scene(n=n, seed=seed, sh_degree=sh)
    ref = j_sphere_scene(n=n, seed=seed, sh_degree=sh)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_orbit_cameras_bit_equal_to_jax_tool(monkeypatch):
    calls = jax_tool_cameras(monkeypatch, "trainsmoke_chip")
    poses = smoke.orbit_poses()
    cams = smoke.orbit_cameras(device="cpu")
    assert len(calls) == len(poses) == smoke.N_VIEWS == 6
    fov = (math.radians(55), math.radians(40))
    for call, (R, T), cam in zip(calls, poses, cams):
        assert_pose_call(call, R, T, fov, (smoke.W, smoke.H))
        assert_camera_equal(cam, jcamera.make_camera(*call))


def test_ring_and_bench_cameras_bit_equal_to_jax_tool(monkeypatch):
    calls = jax_tool_cameras(monkeypatch, "calibrate_scene")
    bench_call, ring_calls = calls[0], calls[1:]
    fov = (calib.FOV, calib.FOV)
    size = (calib.W, calib.H)
    assert_pose_call(bench_call, *calib.bench_pose(), fov, size)
    assert len(ring_calls) == len(calib.ring_poses()) == 24
    for call, pose in zip(ring_calls, calib.ring_poses()):
        assert_pose_call(call, *pose, fov, size)
        assert_camera_equal(calib.camera(pose, device="cpu"),
                            jcamera.make_camera(*call))


def test_bench_scene_bit_equal_to_graft_entry():
    import __graft_entry__

    args, jcam = __graft_entry__._scene(4096, 256, 256)
    ours = calib.bench_scene(4096)
    for k, ref in zip(smoke.KEYS, args):
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], np.asarray(ref), err_msg=k)
    assert_camera_equal(calib.camera(calib.bench_pose(), 256, 256, "cpu"),
                        jcam)


def test_golden_targets_match_jax():
    scene = smoke.sphere_scene(n=300, seed=2)
    poses = smoke.orbit_poses(3)
    ours = smoke.golden_targets(scene, smoke.orbit_cameras(3, 96, 64, "cpu"))
    args = [jnp.asarray(scene[k]) for k in smoke.KEYS]
    render = jax.jit(lambda c: jgolden.render_golden(
        *args, c, 0, cfg=JRasterizerConfig(pair_capacity=1 << 17,
                                           **EXACT))[0])
    for (R, T), img in zip(poses, ours):
        ref = np.asarray(render(jcamera.make_camera(
            R, T, math.radians(55), math.radians(40), 96, 64)))
        assert img.shape == ref.shape == (3, 64, 96)
        assert ref.max() > 0.1
        np.testing.assert_allclose(img, ref, rtol=0, atol=2e-5)


TINY = dict(n=300, views=3, size=(64, 48), n_init=60, capacity=256)
TINY_CFG = dict(sh_degree=0, densify_from_iter=15, densification_interval=15,
                densify_until_iter=30, opacity_reset_interval=1000,
                iterations=40)


@pytest.fixture(scope="module")
def tiny_scene():
    scene = smoke.sphere_scene(n=TINY["n"], seed=2)
    cams = smoke.orbit_cameras(TINY["views"], *TINY["size"], device="cpu")
    return scene, cams, smoke.golden_targets(scene, cams)


def record_run(tr, next_view, iterations):
    """Views, losses and (pre-densify state, stats) of each densify of a
    Trainer of either package, over tr.train(iterations)."""
    views, losses, densifies = [], [], []
    pick, densify = getattr(tr, next_view), tr.densify

    def picked():
        v = pick()
        views.append(v)
        return v

    def densified():
        before = (tr.model.params, tr.model.state)
        stats = densify()
        densifies.append((before, stats))
        return stats

    setattr(tr, next_view, picked)
    tr.densify = densified
    tr.train(iterations, callback=lambda t, out: losses.append(
        float(out.loss)))
    return views, losses, densifies


def near_threshold_rows(params, state, cfg, extent):
    """Alive rows whose densify statistic lies within 1e-4 relative of its
    threshold (gradient, world scale, opacity cull)."""
    alive = np.asarray(state.alive)
    denom = np.asarray(state.denom)
    grads = np.where(denom > 0, np.asarray(state.xyz_grad_accum)
                     / np.maximum(denom, 1e-30), 0.0)
    max_scale = np.exp(np.asarray(params.scaling)).max(axis=1)
    opacity = 1 / (1 + np.exp(-np.asarray(params.opacity)[:, 0]))
    near = np.zeros_like(alive)
    for v, thr in ((grads, cfg.densify_grad_threshold),
                   (max_scale, cfg.percent_dense * extent),
                   (opacity, 0.005)):
        near |= np.abs(v - thr) <= 1e-4 * thr
    return int((near & alive).sum())


def test_tiny_run_matches_jax_until_first_densify(tiny_scene):
    scene, cams, images = tiny_scene
    port = Trainer(
        model=smoke.sparse_init(scene, TINY["n_init"], TINY["capacity"],
                                "cpu"),
        cameras=cams, images=images, cfg=TrainConfig(**TINY_CFG),
        rcfg=RasterizerConfig(pair_capacity=1 << 14), scene_extent=3.0,
        seed=0, device="cpu")
    rng = np.random.default_rng(0)
    sel = rng.choice(TINY["n"], TINY["n_init"], replace=False)
    jm = jg.GaussianModel.from_point_cloud(
        scene["means3d"][sel],
        rng.uniform(0.2, 0.8, (TINY["n_init"], 3)).astype(np.float32),
        max_sh_degree=0, capacity=TINY["capacity"])
    jcams = [jcamera.make_camera(R, T, math.radians(55), math.radians(40),
                                 *TINY["size"])
             for R, T in smoke.orbit_poses(TINY["views"])]
    jtr = jt.Trainer(model=jm, cameras=jcams, images=images,
                     cfg=jt.TrainConfig(**TINY_CFG),
                     rcfg=JRasterizerConfig(pair_capacity=1 << 14, **EXACT),
                     impl="xla", scene_extent=3.0, seed=0)
    first = TINY_CFG["densify_from_iter"]
    j_views, j_losses, j_dens = record_run(jtr, "_next_view", first)
    p_views, p_losses, p_dens = record_run(port, "_next_views",
                                           TINY_CFG["iterations"])

    assert [v for (v,) in p_views[:first]] == j_views
    np.testing.assert_allclose(p_losses[:first], j_losses,
                               rtol=1e-4, atol=0)
    (j_before, j_stats), = j_dens
    near = near_threshold_rows(*j_before, jtr.cfg, 3.0)
    print(f"rows within 1e-4 of a densify threshold: {near}")
    p_stats = p_dens[0][1]
    for k in ("n_clone", "n_split", "n_prune"):
        assert abs(int(p_stats[k]) - int(j_stats[k])) <= near, (
            k, p_stats[k], j_stats[k])
    assert int(j_stats["n_clone"]) + int(j_stats["n_split"]) > 0

    # After the first densify only the tool's own checks apply, the loss's
    # at this run's length: it falls (the tool asks half over 1,200).
    assert len(p_dens) == 2 and len(p_losses) == TINY_CFG["iterations"]
    assert smoke.params_finite(port.model)
    assert np.mean(p_losses[-10:]) < 0.9 * p_losses[0], p_losses
    assert port.num_alive() > TINY["n_init"]


def test_forced_growth_fires_both_growths(tiny_scene):
    scene, cams, images = tiny_scene
    tr, rec = smoke.forced_growth(scene, cams, images,
                                  n_init=TINY["n_init"])
    assert rec["taken_steps"] == tr.iteration == 120
    assert rec["capacity_grows"] >= 1 and rec["pair_capacity_grows"] >= 1
    assert rec["model_capacity_final"] > 2 * TINY["n_init"]
    assert rec["pair_capacity_final"] > rec["pair_capacity_start"]
    assert rec["over_capacity_steps"] == []
    assert len(rec["densifies"]) == 5
    assert rec["alive_final"] > 4 * TINY["n_init"]
    assert rec["params_finite"] and np.isfinite(rec["losses"]).all()
    # The plain path on the CPU launches no kernel.
    assert set(rec["launches"].values()) == {0}


def test_tools_default_to_cuda():
    """Without device=..., the tools ask for CUDA and raise where there is
    none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    for main in (smoke.main, calib.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main()
