"""The port's multi-rank package (gs2mesh_torch.parallel) and the strided
tile-row mode of K1-K3's plain versions, held to the JAX package.

* Strided mode: for G in {1, 2, 3, 4} and every slice, the plain strided
  emission equals JAX's ``emission_core(..., row_offset=ax)`` under
  ``row_stride=G`` (keys, ids, num_pairs); the stitched slices of the plain
  compositor equal the unsharded render within 2e-5; the per-gaussian
  gradients summed over the slices equal the unsharded ones.
* The sharded step in gloo worlds of (data 2 x gauss 2) and (1 x 4) on
  tests/test_sharded_train.py's scene, against JAX's single-chip render_model
  + gs_loss gradients averaged over the views and one optax update (JAX's
  own limits), the densification statistics against the single-device
  port's, and the sharded loss against gs_loss on the stitched image.
* ShardedTrainer on (1 x 2): densify + opacity reset against the port's
  Trainer, identical whole-model rows on every rank, an overflow redo, a
  checkpoint round trip; the sharded DLNR and TSDF integrate on (2 x 1);
  train_gs(devices=2); a torchrun-style two-process multihost step.

The workers (tests/test_torch_dist_workers.py) run in spawned processes over a
file store, so they never share a port; JAX is imported here only inside
the functions that need it.
"""

from __future__ import annotations

import functools
import math
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.composite import composite
from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emission_plain,
                                               sort_pairs)
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.parallel.sharded_train import (image_slice, local_rects,
                                                  slice_rows, stitch_slices)
from gs2mesh_torch.train.trainer import TrainConfig
from tests import test_torch_dist_workers as W
from tests.scenes import sphere_scene
from tests.test_torch_core import look_at_camera

torch.set_num_threads(2)

KEYS = ("means3d", "scales", "rotations", "opacities", "shs")
CFG = RasterizerConfig(pair_capacity=1 << 13)
# Two tile rows tall, ragged, and five tile rows tall (every slice at
# G = 2 and 3 holds more than one local tile row).
SIZES = [(64, 64), (72, 40), (64, 160)]


def spawn(fn, world: int, tmp_path, *args, env=None, timeout=300):
    """Runs W.run(fn, rank, ...) in ``world`` spawned processes; returns
    each rank's saved results dict by name."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(
        fn, r, world, str(tmp_path / "store"), str(out), args, env))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
        err = out / f"error_rank{r}.txt"
        assert p.exitcode == 0, err.read_text() if err.exists() else \
            f"rank {r} exit code {p.exitcode}"
    res = {}
    for f in sorted(os.listdir(out)):
        if f.endswith(".pt"):
            name, rank = f[:-3].rsplit("_rank", 1)
            res.setdefault(name, {})[int(rank)] = torch.load(
                out / f, weights_only=False)
    return res


# ---------------------------------------------------------------------------
# The strided mode of the plain K1-K3
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def strided_case(width, height):
    s = sphere_scene(n=256)
    cam = look_at_camera((0.0, 0.0, -3.0), width, height)
    with torch.no_grad():
        prep = preprocess(*(torch.from_numpy(s[k]) for k in KEYS), cam, 0,
                          CFG)
    return s, cam, prep


def jax_strided_emission(s, width, height, G, ax):
    """JAX: preprocess, the rect clip of parallel/sharded_train.py:114-120,
    then emission_core at (row_offset=ax, row_stride=G)."""
    import dataclasses

    import jax.numpy as jnp

    from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JCfg
    from gs2mesh_tpu.ops.rasterizer.emit import build_feat9 as j_feat9
    from gs2mesh_tpu.ops.rasterizer.emit import emission_core
    from gs2mesh_tpu.ops.rasterizer.preprocess import preprocess as j_prep
    from tests.scenes import look_at_camera as j_cam

    jcfg = JCfg(pair_capacity=CFG.pair_capacity, feat_carry_bf16=False,
                grad_carry_bf16=False)
    prep = j_prep(*(jnp.asarray(s[k]) for k in KEYS),
                  j_cam((0.0, 0.0, -3.0), width=width, height=height), 0,
                  jcfg)
    gy = jcfg.grid_size(width, height)[1]
    rows_per = -(-gy // G)
    rect = prep.rect
    y0l = jnp.clip(-((ax - rect[:, 1]) // G), 0, rows_per)
    y1l = jnp.clip((rect[:, 3] - 1 - ax) // G + 1, 0, rows_per)
    y1l = jnp.maximum(y0l, y1l)
    rect_loc = jnp.stack([rect[:, 0], y0l, rect[:, 2], y1l], axis=1)
    tiles_loc = jnp.where(prep.tiles_touched > 0,
                          (rect[:, 2] - rect[:, 0]) * (y1l - y0l), 0)
    return emission_core(j_feat9(prep), prep.depths, rect_loc, tiles_loc,
                         width, rows_per * jcfg.tile,
                         dataclasses.replace(jcfg, row_stride=G), ax)


def strided_emission(prep, width, height, G, ax, key_tiles=None):
    rows_per, h_slice = slice_rows(height, CFG, G)
    rect_loc, tiles_loc = local_rects(prep.rect, prep.tiles_touched,
                                      rows_per, ax, G)
    em = emission_plain(build_feat9(prep), prep.depths, rect_loc, tiles_loc,
                        width, h_slice, CFG, row_offset=ax, row_stride=G,
                        key_tiles=key_tiles)
    return em, tiles_loc, rows_per, h_slice


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("G", [1, 2, 3, 4])
def test_strided_emission_matches_jax(size, G):
    width, height = size
    s, _, prep = strided_case(width, height)
    total = 0
    for ax in range(G):
        ref = jax_strided_emission(s, width, height, G, ax)
        em, _, _, _ = strided_emission(prep, width, height, G, ax)
        assert int(em.num_pairs) == int(ref.num_pairs)
        np.testing.assert_array_equal(em.keys.numpy(),
                                      np.asarray(ref.key).astype(np.int64))
        np.testing.assert_array_equal(em.ids.numpy(),
                                      np.asarray(ref.emission_ids))
        total += int(em.num_pairs)
    assert total == int(prep.tiles_touched.sum()) > 0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("G", [1, 2, 3, 4])
def test_stitched_slices_equal_unsharded(size, G):
    """Colour and final_T stitched from the G slices equal the unsharded
    render (2e-5), and the per-gaussian gradients of a seeded cotangent
    summed over the slices equal the unsharded gradient (atol 5e-5,
    rtol 5e-3). Each slice's key is sized for the whole image."""
    width, height = size
    _, _, prep = strided_case(width, height)
    gx, gy = CFG.grid_size(width, height)
    feat9 = build_feat9(prep).detach().requires_grad_(True)
    rng = np.random.default_rng(G)
    dC = torch.from_numpy(rng.normal(size=(3, height, width)).astype(
        np.float32))
    dT = torch.from_numpy(rng.normal(size=(height, width)).astype(np.float32))

    em = emission_plain(feat9.detach(), prep.depths, prep.rect,
                        prep.tiles_touched, width, height, CFG)
    color, final_T, _ = composite(feat9, sort_pairs(em, gx * gy),
                                  prep.tiles_touched, width, height, CFG)
    (grad,) = torch.autograd.grad((color * dC).sum() + (final_T * dT).sum(),
                                  feat9)

    colors, Ts, grads = [], [], torch.zeros_like(feat9)
    for ax in range(G):
        em_s, tiles_loc, rows_per, h_slice = strided_emission(
            prep, width, height, G, ax, key_tiles=gx * gy)
        pairs = sort_pairs(em_s, gx * rows_per, key_tiles=gx * gy)
        c, t, _ = composite(feat9, pairs, tiles_loc, width, h_slice, CFG,
                            row_offset=ax, row_stride=G)
        colors.append(c.detach())
        Ts.append(t.detach()[None])
        (g,) = torch.autograd.grad(
            (c * image_slice(dC, G, ax, h_slice, CFG.tile)).sum()
            + (t * image_slice(dT[None], G, ax, h_slice, CFG.tile)[0]).sum(),
            feat9)
        grads += g
    np.testing.assert_allclose(stitch_slices(colors, height, CFG.tile),
                               color.detach(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(stitch_slices(Ts, height, CFG.tile)[0],
                               final_T.detach(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(grads, grad, atol=5e-5, rtol=5e-3)
    assert float(grad.abs().max()) > 0


def test_local_rects_partition_every_rect():
    """Over the G slices, every gaussian's clipped rows partition its rect's
    rows (each global row r to slice r mod G)."""
    _, _, prep = strided_case(72, 40)
    for G in (2, 3, 5):
        rows_per, _ = slice_rows(40, CFG, G)
        tiles = sum(local_rects(prep.rect, prep.tiles_touched, rows_per, ax,
                                G)[1] for ax in range(G))
        np.testing.assert_array_equal(tiles.numpy(),
                                      prep.tiles_touched.numpy())


# ---------------------------------------------------------------------------
# The sharded step (gloo worlds) against JAX's single-chip update
# ---------------------------------------------------------------------------

STEP_CFG = TrainConfig(sh_degree=0)


@functools.lru_cache(maxsize=None)
def step_case():
    """tests/test_sharded_train.py:16-76's construction: JAX's model,
    the golden-rendered targets, and the port's cameras."""
    import jax
    import jax.numpy as jnp

    from gs2mesh_tpu.models.gaussians import GaussianModel as JModel
    from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JCfg
    from gs2mesh_tpu.ops.rasterizer.golden import render_golden
    from tests.scenes import look_at_camera as j_cam

    scene = sphere_scene(n=100, seed=7)
    eyes = [(0, 0, -3.0), (0.4, 0.2, -2.9)]
    jcams = [j_cam(e, width=64, height=64) for e in eyes]
    rng = np.random.default_rng(8)
    cols = rng.uniform(0.2, 0.8, size=(100, 3)).astype(np.float32)
    jmodel = JModel.from_point_cloud(scene["means3d"], cols, max_sh_degree=0,
                                     capacity=128)
    jcfg = JCfg(pair_capacity=1 << 13, feat_carry_bf16=False,
                grad_carry_bf16=False)
    targets = [np.array(jax.jit(lambda c=c: render_golden(
        *(jnp.asarray(scene[k]) for k in KEYS), c, 0, cfg=jcfg))()[0])
        for c in jcams]
    init = dict(params={k: np.asarray(v) for k, v in
                        zip(jmodel.params._fields, jmodel.params)},
                state={k: np.asarray(v) for k, v in
                       zip(jmodel.state._fields, jmodel.state)},
                max_sh_degree=0, spatial_lr_scale=jmodel.spatial_lr_scale)
    cams = [look_at_camera(e, 64, 64) for e in eyes]
    return jmodel, jcams, jcfg, targets, init, cams


@functools.lru_cache(maxsize=None)
def jax_reference(n_views):
    """JAX's single-chip update: render_model + gs_loss gradients averaged
    over the first n_views views, one optax update; the mean loss."""
    import jax
    import jax.numpy as jnp

    from gs2mesh_tpu.ops.ssim import gs_loss
    from gs2mesh_tpu.train.trainer import TrainConfig as JTrainConfig
    from gs2mesh_tpu.train.trainer import make_optimizer, render_model

    jmodel, jcams, jcfg, targets, _, _ = step_case()
    cfg = JTrainConfig(sh_degree=0)
    tx = make_optimizer(cfg, jmodel.spatial_lr_scale)
    opt_state = tx.init(jmodel.params)

    def loss_one(params, cam, target):
        out = render_model(params, jmodel.state.alive, cam, 0, jnp.zeros(3),
                           jcfg, "xla", max_per_tile=1024)
        return gs_loss(out.image, target, cfg.lambda_dssim)

    losses, grads = zip(*(jax.value_and_grad(loss_one)(
        jmodel.params, jcams[v], jnp.asarray(targets[v]))
        for v in range(n_views)))
    gm = jax.tree.map(lambda *g: sum(g) / float(n_views), *grads)
    upd, _ = tx.update(gm, opt_state, jmodel.params)
    params = jax.tree.map(lambda p, u: p + u, jmodel.params, upd)
    return (float(np.mean([float(x) for x in losses])),
            {k: np.asarray(v) for k, v in zip(params._fields, params)})


@functools.lru_cache(maxsize=None)
def port_stats(n_views):
    """The single-device port's densification statistics over the views,
    summed (max for the radii), each view from the initial model."""
    from gs2mesh_torch.train.trainer import make_optimizer, train_step

    _, _, _, targets, init, cams = step_case()
    acc = None
    for v in range(n_views):
        model = W._model(init)
        for leaf in model.params.tensors():
            leaf.requires_grad_(True)
        opt = make_optimizer(model.params, STEP_CFG, model.spatial_lr_scale)
        train_step(model, opt, cams[v], torch.from_numpy(targets[v]),
                   torch.zeros(3), STEP_CFG, CFG, 0)
        st = {k: getattr(model.state, k).numpy() for k in
              ("xyz_grad_accum", "denom", "max_radii2D")}
        acc = st if acc is None else {
            k: np.maximum(acc[k], st[k]) if k == "max_radii2D"
            else acc[k] + st[k] for k in st}
    return acc


@functools.lru_cache(maxsize=None)
def _step_world(tmp_root, D, G):
    _, _, _, targets, init, cams = step_case()
    tmp = tmp_root / f"step_{D}x{G}"
    tmp.mkdir()
    return spawn(W.sharded_step, D * G, tmp, D, G, init, cams, targets,
                 STEP_CFG, CFG)["step"]


@pytest.fixture(scope="module")
def step_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    return lambda D, G: _step_world(root, D, G)


MESHES = [(2, 2), (1, 4)]


@pytest.mark.parametrize("D,G", MESHES)
def test_sharded_step_matches_jax_single_chip(step_world, D, G):
    res = step_world(D, G)
    ref_loss, ref_params = jax_reference(D)
    for r in range(D * G):
        assert res[r]["loss"] == pytest.approx(ref_loss, rel=1e-4)
        assert not res[r]["overflow"]
    got = res[0]["model"]["params"]
    for k, v in ref_params.items():
        np.testing.assert_allclose(got[k], v, atol=5e-5, err_msg=k)
    for r in range(1, D * G):      # every rank gathers the same model
        for k in got:
            np.testing.assert_array_equal(res[r]["model"]["params"][k],
                                          got[k])


@pytest.mark.parametrize("D,G", MESHES)
def test_sharded_densify_stats_match_single_device(step_world, D, G):
    """The G-fold trap: the statistics are the single-device port's summed
    over the views, not G times them."""
    state = step_world(D, G)[0]["model"]["state"]
    ref = port_stats(D)
    for k, v in ref.items():
        tol = 1e-5 * float(np.abs(v).max())
        np.testing.assert_allclose(state[k], v, atol=tol, rtol=0, err_msg=k)
    assert float(ref["xyz_grad_accum"].max()) > 0


@pytest.mark.parametrize("D,G", MESHES)
def test_sharded_loss_equals_gs_loss_on_stitched_image(step_world, D, G):
    res = step_world(D, G)
    _, _, _, targets, _, _ = step_case()
    for r in range(D * G):
        assert abs(res[r]["sharded_loss"] - res[r]["stitched_loss"]) <= 1e-6
    pairs = res[0]["pairs"]    # 64x64 has 2 tile rows: slices past them
    assert pairs.shape == (G,) and (pairs[:2] > 0).all() and \
        (pairs[2:] == 0).all()


@pytest.mark.parametrize("G", [2, 3])
def test_sharded_loss_and_render_on_tall_slices(tmp_path, G):
    """At 64x160 (five tile rows) every slice holds more than one tile row,
    so the l*row_stride placement, the ring wrap of the halo exchange
    (ax == 0 and ax == G-1) and the per-row target gather all run: the
    sharded loss of a seeded image equals gs_loss on it (1e-6), the
    gradient each rank gets for its slice equals that slice of gs_loss's
    gradient, and the stitched sharded render equals the unsharded one
    (2e-5)."""
    from gs2mesh_torch.ops.ssim import gs_loss
    from gs2mesh_torch.parallel.sharded_train import slice_rows
    from gs2mesh_torch.train.trainer import render_model

    width, height = SIZES[2]
    lam = STEP_CFG.lambda_dssim
    rng = np.random.default_rng(G)
    image, target = (rng.uniform(size=(3, height, width)).astype(np.float32)
                     for _ in range(2))
    _, _, _, _, init, _ = step_case()
    cam = look_at_camera((0.0, 0.0, -3.0), width, height)
    res = spawn(W.tall_slices, G, tmp_path, G, image, target, init, cam, CFG,
                lam)["tall"]

    img = torch.from_numpy(image).requires_grad_(True)
    loss = gs_loss(img, torch.from_numpy(target), lam)
    (grad,) = torch.autograd.grad(loss, img)
    loss = float(loss.detach())
    model = W._model(init)
    with torch.no_grad():
        ref = render_model(model.params, model.state.alive, cam, 0,
                           torch.zeros(3), CFG).image
    _, h_slice = slice_rows(height, CFG, G)
    for ax in range(G):
        got = res[ax]
        assert got["rows_per"] >= 2 and got["num_pairs"] > 0
        assert abs(got["loss"] - loss) <= 1e-6
        np.testing.assert_allclose(
            got["grad"], image_slice(grad, G, ax, h_slice, CFG.tile),
            rtol=1e-4, atol=1e-6 * float(grad.abs().max()))
        np.testing.assert_allclose(got["stitched"], ref, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# ShardedTrainer, inference, train_gs and multihost
# ---------------------------------------------------------------------------

TRAIN_CFG = TrainConfig(sh_degree=0, iterations=8, densify_from_iter=2,
                        densification_interval=3, opacity_reset_interval=5,
                        densify_grad_threshold=1e-5)


@functools.lru_cache(maxsize=None)
def volume_case():
    from gs2mesh_torch.fusion.tsdf import TSDFConfig
    from tests.test_torch_fusion import sphere_views

    cfg = TSDFConfig(voxel_size=0.04, sdf_trunc=0.12, block_size=8,
                     block_capacity=1024, alloc_stride=4)
    frames = [tuple(np.asarray(x, np.float32) for x in f)
              for f in list(sphere_views())[:4]]
    return cfg, frames


@functools.lru_cache(maxsize=None)
def stereo_case():
    rng = np.random.default_rng(5)
    im1 = rng.uniform(0, 255, size=(2, 3, 64, 96)).astype(np.float32)
    im2 = np.roll(im1, -3, axis=3)
    return 11, im1, im2


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    _, _, _, targets, init, cams = step_case()
    return spawn(W.trainer_world, 2, tmp, init, cams, targets, TRAIN_CFG,
                 CFG, stereo_case(), volume_case(),
                 str(tmp / "ckpt"))["trainer"]


def test_sharded_trainer_densify_matches_trainer(trainer_world):
    """The alive count after densify + opacity reset equals the port's
    Trainer's on the same seeds; every rank computed the same whole-model
    rows at each densify. The densifies after the reset at 5 run the size
    prune, and it removes exactly the opacity and world-size candidates:
    no row goes for its screen size (max_radii2D comes back zero)."""
    from gs2mesh_torch.train.trainer import Trainer

    _, _, _, targets, init, cams = step_case()
    ref = Trainer(model=W._model(init), cameras=cams, images=targets,
                  cfg=TRAIN_CFG, rcfg=CFG, seed=3, device="cpu")
    ref.train(TRAIN_CFG.iterations)
    r0, r1 = trainer_world[0], trainer_world[1]
    assert r0["alive"] == r1["alive"] == ref.model.num_alive()
    assert r0["capacity"] == ref.model.capacity
    # Iterations 3 and 6, then 9 in the restored trainer's extra step.
    assert len(r0["densify"]) == len(r1["densify"]) == 3
    for a, b in zip(r0["densify"], r1["densify"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    sizes = []
    for *_, radii, (size, n_prune, candidates) in r0["densify"]:
        assert not radii.any()
        assert n_prune == candidates
        sizes.append(float(size))
    assert sizes == [0.0, 20.0, 20.0]
    np.testing.assert_array_equal(r0["model"]["state"]["alive"],
                                  ref.model.state.alive.numpy())


def test_sharded_trainer_overflow_grows_and_redoes(trainer_world):
    for r in (0, 1):
        assert trainer_world[r]["grown_capacity"] > 64
        assert trainer_world[r]["grown_iteration"] == 2


def test_sharded_checkpoint_round_trip(trainer_world):
    ck = trainer_world[0]["ckpt"]
    assert ck["iteration"] == TRAIN_CFG.iterations
    assert ck["restored_alive"][:ck["n"]].all()
    assert not ck["restored_alive"][ck["n"]:].any()
    for saved, restored in ck["params"] + ck["moments"]:
        np.testing.assert_array_equal(saved, restored)
    assert ck["loss_after"]


def test_sharded_loss_g1_equals_gs_loss(trainer_world):
    for r in (0, 1):
        sharded, plain = trainer_world[r]["g1_losses"]
        assert abs(sharded - plain) <= 1e-6


def test_sharded_dlnr_matches_single_forward(trainer_world):
    from gs2mesh_torch.stereo import DLNR, DLNRConfig, dlnr_forward
    from gs2mesh_torch.stereo.dlnr import init_dlnr_

    seed, im1, im2 = stereo_case()
    model = init_dlnr_(DLNR(), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        flow, disp = dlnr_forward(model, torch.from_numpy(im1),
                                  torch.from_numpy(im2), DLNRConfig(iters=1))
    for r in (0, 1):
        for got, ref in ((trainer_world[r]["flow"], flow),
                         (trainer_world[r]["disp"], disp)):
            ref = ref.numpy()
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())


def test_sharded_integrate_equals_single_device(trainer_world):
    from gs2mesh_torch.fusion.tsdf import create_volume, integrate_view

    cfg, frames = volume_case()
    vol = create_volume(cfg, "cpu")
    for color, depth, K, E in frames:
        vol = integrate_view(vol, *(torch.from_numpy(x) for x in
                                    (color, depth, K, E)), 3.0, cfg)
    assert vol.n_blocks > 0 and not vol.overflow
    for r in (0, 1):
        got = trainer_world[r]
        assert got["n_blocks"] == vol.n_blocks
        for k, v in got["volume"].items():
            np.testing.assert_array_equal(v, getattr(vol, k).numpy(),
                                          err_msg=k)


def test_train_gs_devices_2_builds_a_sharded_trainer(tmp_path):
    from tests.test_torch_gs_tools_eval import write_scene

    src = tmp_path / "scene"
    write_scene(str(src), n=200, size=64)
    res = spawn(W.train_gs_world, 2, tmp_path, str(src),
                str(tmp_path / "model"))["train_gs"]
    for r in (0, 1):
        assert res[r]["sharded"] and res[r]["iteration"] == 3
        assert res[r]["capacity"] % 2 == 0
    for it in (2, 3):
        assert (tmp_path / "model" / f"chkpnt{it}.pt").exists()
        assert (tmp_path / "model" / "point_cloud" / f"iteration_{it}" /
                "point_cloud.ply").exists()


def test_train_gs_devices_2_without_a_world_names_torchrun(tmp_path):
    from gs2mesh_torch.pipeline.run_single import train_gs

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train_gs(str(tmp_path), str(tmp_path / "m"), 3, [3], False,
                 devices=2, device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_two_processes_take_one_sharded_step(tmp_path):
    """tests/test_multihost.py's counterpart: torchrun-style environment
    variables, a (2 x 1) hybrid mesh, one data-parallel sharded step."""
    _, _, _, targets, init, cams = step_case()
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    res = spawn(W.multihost, 2, tmp_path, init, cams[0], targets[0],
                STEP_CFG, CFG, env=env)["multihost"]
    for r in (0, 1):
        assert res[r]["world"] == 2 and res[r]["backend"] == "gloo"
        assert res[r]["mesh_shape"] == (2, 1)
        assert res[r]["local_batch"] == 2
        assert math.isfinite(res[r]["loss"])
    assert res[0]["loss"] == res[1]["loss"]
    np.testing.assert_array_equal(res[0]["xyz"], res[1]["xyz"])
    assert not np.array_equal(res[0]["xyz"], init_xyz())


def init_xyz():
    return step_case()[4]["params"]["xyz"]


def test_make_mesh_needs_a_process_group():
    from gs2mesh_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        make_mesh(2, 2, "cpu")


def test_halo_exchange_at_g1_wraps_the_ranks_own_rows():
    """At G = 1 the ring is the identity: every tile row is extended by the
    true neighbouring pixel rows of the image, zeros past its edges."""
    from gs2mesh_torch.parallel.sharded_train import (HALO,
                                                      exchange_halos_strided)

    img = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 96, 8)).astype(np.float32))
    ext = exchange_halos_strided(img.reshape(3, 3, 32, 8), 0, 1, None)
    pad = torch.nn.functional.pad(img, (0, 0, HALO, HALO))
    for r in range(3):
        assert torch.equal(ext[:, r], pad[:, r * 32:(r + 1) * 32 + 2 * HALO])


def test_owned_rows_and_batched_cameras():
    from gs2mesh_torch.parallel import batch_cameras, index_camera, owned_rows

    assert owned_rows(128, 4, 2) == slice(64, 96)
    with pytest.raises(ValueError):
        owned_rows(130, 4, 0)
    _, _, _, _, _, cams = step_case()
    b = batch_cameras(cams)
    assert b.world_view.shape == (2, 4, 4)
    c1 = index_camera(b, 1)
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
              "tan_fovy"):
        assert torch.equal(getattr(c1, f), getattr(cams[1], f))
    assert (c1.width, c1.height) == (64, 64)
