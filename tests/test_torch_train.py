"""Parity of the PyTorch port's model, optimizer and trainer with the JAX
package, on the CPU (plain versions of kernels K1-K4).

The JAX side runs exact carry, RasterizerConfig(feat_carry_bf16=False,
grad_carry_bf16=False), through impl="xla". Targets are rendered by the
port's plain rasterizer. Tolerances: floats of model surgery 1e-6; the
Adam update on equal gradients 1e-6 relative (the two frameworks round
the bias corrections and the moment updates in another order); losses
1e-5 relative and gradients atol 5e-5, rtol 5e-3 (PARITY.md:45).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.models import gaussians as jg
from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from gs2mesh_tpu.ops.ssim import gs_loss as j_gs_loss
from gs2mesh_tpu.train import trainer as jt
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.png import write_png
from gs2mesh_torch.models.gaussians import (FIELDS, GROUP_OF, DensifyConfig,
                                            GaussianModel,
                                            accumulate_densification_stats,
                                            adam_state_from_numpy,
                                            densify_and_prune_draws,
                                            params_from_numpy, reset_opacity,
                                            state_from_numpy)
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.train.trainer import (TrainConfig, Trainer, expon_lr,
                                         make_optimizer,
                                         optimizer_step_count, train_step,
                                         xyz_lr)
from tests.scenes import look_at_camera as j_look_at_camera
from tests.scenes import sphere_scene
from tests.test_torch_core import look_at_camera

torch.set_num_threads(1)

FIELD_OF = {g: f for f, g in GROUP_OF.items()}
EYES = [(0.0, 0.0, -3.0), (0.3, 0.1, -2.9)]
KEYS = ("means3d", "scales", "rotations", "opacities", "shs")


def np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def port_model(jm) -> GaussianModel:
    return GaussianModel(params=params_from_numpy(np_tree(jm.params), "cpu"),
                         max_sh_degree=jm.max_sh_degree,
                         state=state_from_numpy(np_tree(jm.state), "cpu"),
                         spatial_lr_scale=jm.spatial_lr_scale)


def jax_adam_groups(opt_state):
    """{group: (mu, nu, count)} of an optax multi_transform Adam state."""
    out = {}
    for g, masked in opt_state.inner_states.items():
        adam = masked.inner_state[0]
        f = FIELD_OF[g]
        out[g] = (np.asarray(getattr(adam.mu, f)),
                  np.asarray(getattr(adam.nu, f)), np.asarray(adam.count))
    return out


def jax_with_moments(opt_state, moments, count):
    """opt_state with the given {group: (mu, nu)} and every count set."""
    inner = {}
    for g, masked in opt_state.inner_states.items():
        adam, *rest = masked.inner_state
        f = FIELD_OF[g]
        mu, nu = moments[g]
        adam = adam._replace(mu=adam.mu._replace(**{f: jnp.asarray(mu)}),
                             nu=adam.nu._replace(**{f: jnp.asarray(nu)}),
                             count=jnp.asarray(count, adam.count.dtype))
        rest = [r._replace(count=jnp.asarray(count, r.count.dtype))
                if "count" in r._fields else r for r in rest]
        inner[g] = masked._replace(inner_state=(adam, *rest))
    return opt_state._replace(inner_states=inner)


def point_cloud(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32))


def test_from_point_cloud_matches_jax():
    pts, cols = point_cloud(100, 2)
    jm = jg.GaussianModel.from_point_cloud(pts, cols, max_sh_degree=2,
                                           capacity=256, spatial_lr_scale=1.5)
    m = GaussianModel.from_point_cloud(pts, cols, max_sh_degree=2,
                                       capacity=256, spatial_lr_scale=1.5,
                                       device="cpu")
    assert (m.capacity, m.num_alive(), m.spatial_lr_scale) == (256, 100, 1.5)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(m.params, f).numpy(),
                                   np.asarray(getattr(jm.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    for f, v in np_tree(jm.state).items():
        np.testing.assert_array_equal(getattr(m.state, f).numpy(), v)
    ri = m.raster_inputs()
    assert np.all(ri["opacities"].numpy()[100:] == 0)


def test_ply_capacity_roundtrip(tmp_path):
    pts, cols = point_cloud(100, 2)
    m = GaussianModel.from_point_cloud(pts, cols, max_sh_degree=1,
                                       capacity=256, device="cpu")
    path = str(tmp_path / "m.ply")
    m.save_ply(path)
    back = GaussianModel.load_ply(path, 1, capacity=256, device="cpu")
    ref = jg.GaussianModel.load_ply(path, 1, capacity=256)
    assert back.num_alive() == 100 and back.active_sh_degree == 1
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back.params, f).numpy(),
                                      np.asarray(getattr(ref.params, f)))
    np.testing.assert_array_equal(back.state.alive.numpy(),
                                  np.asarray(ref.state.alive))


def test_stats_and_reset_opacity_match_jax():
    rng = np.random.default_rng(4)
    pts, cols = point_cloud(20, 4)
    jm = jg.GaussianModel.from_point_cloud(pts, cols, max_sh_degree=0,
                                           capacity=32)
    m = port_model(jm)
    g = rng.normal(scale=1e-3, size=(32, 2)).astype(np.float32)
    radii = rng.integers(-1, 5, size=32).clip(0).astype(np.int32)
    js = jg.accumulate_densification_stats(jm.state, jnp.asarray(g),
                                           jnp.asarray(radii), 96, 64)
    s = accumulate_densification_stats(m.state, torch.from_numpy(g),
                                       torch.from_numpy(radii), 96, 64)
    for f, v in np_tree(js).items():
        np.testing.assert_allclose(getattr(s, f).numpy(), v, rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    jp = jg.reset_opacity(jm.params, jm.state.alive)
    p = reset_opacity(m.params, m.state.alive)
    np.testing.assert_allclose(p.opacity.numpy(), np.asarray(jp.opacity),
                               rtol=1e-6, atol=1e-6)
    assert np.all(torch.sigmoid(p.opacity[:20]).numpy() <= 0.01 + 1e-6)


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0])
def test_densify_and_prune_matches_jax(max_screen_size):
    """Forced clone / split / prune plus random gradients, with JAX's
    normal draws for the same key: row for row equal, Adam rows zeroed
    alike. Without the size prune the candidates outnumber the dead slots
    (overflow); with it, the forced split is pruned by its world size and
    the pruned rows leave room.

    The port gets radii of 0-30 px; JAX gets the same state with
    max_radii2D zeroed, the reference's state at its prune: graphdeco's
    scene/gaussian_model.py ``densification_postfix`` sets
    ``self.max_radii2D = torch.zeros(...)`` for every row, and
    ``densify_and_clone`` and ``densify_and_split`` both call it before
    ``densify_and_prune`` calls ``prune_points``. The port's returned
    max_radii2D is zero."""
    pts, cols = point_cloud(50, 3)
    jm = jg.GaussianModel.from_point_cloud(pts, cols, max_sh_degree=1,
                                           capacity=64)
    rng = np.random.default_rng(5)
    C = jm.capacity
    grads = rng.uniform(0, 2e-3, size=C).astype(np.float32)
    grads[:3] = [1.0, 1.0, 0.0]
    scaling = np.array(jm.params.scaling)
    scaling[0], scaling[1] = np.log(1e-4), np.log(10.0)
    scaling[3:50] += rng.normal(scale=1.0, size=(47, 3)).astype(np.float32)
    opacity = np.array(jm.params.opacity)
    opacity[2] = -10.0
    opacity[3:50, 0] = rng.normal(size=47).astype(np.float32)
    params = jm.params._replace(scaling=jnp.asarray(scaling),
                                opacity=jnp.asarray(opacity),
                                rotation=jnp.asarray(rng.normal(
                                    size=(C, 4)).astype(np.float32)))
    state = jm.state._replace(
        xyz_grad_accum=jnp.asarray(grads), denom=jnp.ones(C, jnp.float32),
        max_radii2D=jnp.asarray(rng.uniform(0, 30, size=C).astype(
            np.float32)))
    cfg = TrainConfig()
    tx = jt.make_optimizer(cfg, 1.0)
    moments = {g: (rng.normal(size=np.shape(getattr(params, f))).astype(
        np.float32), rng.uniform(size=np.shape(getattr(params, f))).astype(
        np.float32)) for g, f in FIELD_OF.items()}
    opt = jax_with_moments(tx.init(params), moments, 7)
    dcfg = DensifyConfig(grad_threshold=1e-3, percent_dense=0.01,
                         max_screen_size=max_screen_size)
    key = jax.random.PRNGKey(0)
    jp, js, jopt, jstats = jg.densify_and_prune(
        params, state._replace(max_radii2D=jnp.zeros(C, jnp.float32)), opt,
        2.0, dcfg, key, 1)
    k1, k2 = jax.random.split(key)
    z1 = torch.tensor(np.asarray(jax.random.normal(k1, (C, 3))))
    z2 = torch.tensor(np.asarray(jax.random.normal(k2, (C, 3))))

    m = GaussianModel(params_from_numpy(np_tree(params), "cpu"), 1,
                      state_from_numpy(np_tree(state), "cpu"))
    optimizer = make_optimizer(m.params, cfg, 1.0)
    adam_state_from_numpy(optimizer, jax_adam_groups(opt))
    p, s, stats = densify_and_prune_draws(m.params, m.state, optimizer, 2.0,
                                          dcfg, z1, z2)
    for k in ("n_clone", "n_split", "n_prune", "n_new", "n_granted",
              "overflow"):
        assert stats[k] == jstats[k], k
    assert stats["n_clone"] >= 1 and stats["n_prune"] >= 1
    assert stats["n_granted"] >= 1
    assert stats["overflow"] == (stats["n_split"] >= 1) == (
        max_screen_size == 0)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f, v in np_tree(js).items():
        np.testing.assert_array_equal(getattr(s, f).numpy(), v, err_msg=f)
    assert not s.max_radii2D.any()
    ref = jax_adam_groups(jopt)
    for group in optimizer.param_groups:
        st = optimizer.state[group["params"][0]]
        mu, nu, count = ref[group["name"]]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu)
        assert int(st["step"]) == int(count) == 7



def test_size_prune_keeps_rows_ever_large_on_screen():
    """The fault the zeroed radii repair: every alive row has been over
    20 px on screen (max_radii2D 21-40) and passes the opacity and
    world-size tests. JAX's densify at max_screen_size 20 prunes them all
    and empties the model; the port, like the reference (whose
    ``densification_postfix`` zeroes max_radii2D before ``prune_points``),
    keeps them all."""
    pts, cols = point_cloud(50, 3)
    jm = jg.GaussianModel.from_point_cloud(pts, cols, max_sh_degree=1,
                                           capacity=64)
    C = jm.capacity
    alive = np.asarray(jm.state.alive)
    radii = np.where(alive, np.random.default_rng(1).uniform(
        21, 40, size=C), 0).astype(np.float32)
    state = jm.state._replace(max_radii2D=jnp.asarray(radii))
    extent = 30.0
    opacity = 1 / (1 + np.exp(-np.asarray(jm.params.opacity[:, 0])))
    max_scale = np.exp(np.asarray(jm.params.scaling)).max(1)
    assert (opacity[alive] >= 0.005).all()
    assert (max_scale[alive] <= 0.1 * extent).all()
    dcfg = DensifyConfig(max_screen_size=20.0)

    _, js, _, jstats = jg.densify_and_prune(jm.params, state, None, extent,
                                            dcfg, jax.random.PRNGKey(0), 1)
    assert int(jstats["n_prune"]) == alive.sum() == 50
    assert not np.asarray(js.alive).any()

    m = GaussianModel(params_from_numpy(np_tree(jm.params), "cpu"), 1,
                      state_from_numpy(np_tree(state), "cpu"))
    z = torch.zeros((C, 3))
    _, s, stats = densify_and_prune_draws(m.params, m.state, None, extent,
                                          dcfg, z, z)
    assert stats["n_prune"] == 0
    np.testing.assert_array_equal(s.alive.numpy(), alive)
    assert not s.max_radii2D.any()

def test_expon_lr_matches_jax():
    assert expon_lr(0, 1e-2, 1e-4, max_steps=100) == pytest.approx(1e-2,
                                                                   rel=1e-6)
    assert expon_lr(100, 1e-2, 1e-4, max_steps=100) == pytest.approx(
        1e-4, rel=1e-6)
    for step, delay in ((37, 0), (37, 50), (400, 50)):
        assert expon_lr(step, 1.6e-4, 1.6e-6, delay, 0.01, 300) == \
            pytest.approx(float(jt.expon_lr(step, 1.6e-4, 1.6e-6, delay,
                                            0.01, 300)), rel=1e-6)


@pytest.mark.parametrize("count", [0, 5])
def test_adam_update_matches_optax(count):
    """One per-group Adam update on equal gradients and moments is within
    1e-6 of optax's, in parameter units. Relative agreement is 1e-5: optax
    rounds the bias corrections 1 - beta^t in float32 (1.3e-5 relative for
    beta2 = 0.999 at t = 1, 6.5e-6 after the square root), torch in
    float64. The port's update is read off parameters set to zero, so the
    parameters' own rounding does not enter."""
    pts, cols = point_cloud(40, 6)
    jm = jg.GaussianModel.from_point_cloud(pts, cols, max_sh_degree=1,
                                           capacity=48, spatial_lr_scale=2.5)
    rng = np.random.default_rng(count)
    cfg = TrainConfig()
    tx = jt.make_optimizer(cfg, 2.5)
    shapes = {f: np.shape(getattr(jm.params, f)) for f in FIELDS}
    moments = {}
    for f, s in shapes.items():
        mu = rng.normal(scale=1e-3, size=s).astype(np.float32)
        nu = (mu ** 2 * rng.uniform(1, 4, size=s) + 1e-8).astype(np.float32)
        moments[GROUP_OF[f]] = (mu, nu)
    opt = jax_with_moments(tx.init(jm.params), moments, count)
    grads = {f: rng.normal(scale=1e-3, size=s).astype(np.float32)
             for f, s in shapes.items()}
    jgrads = jm.params._replace(**{f: jnp.asarray(g)
                                   for f, g in grads.items()})
    updates, _ = tx.update(jgrads, opt, jm.params)

    m = port_model(jm)
    optimizer = make_optimizer(m.params, cfg, m.spatial_lr_scale)
    adam_state_from_numpy(optimizer, jax_adam_groups(opt))
    for f, leaf in zip(FIELDS, m.params.tensors()):
        leaf.zero_()
        leaf.requires_grad_(True)
        leaf.grad = torch.from_numpy(grads[f])
    optimizer.param_groups[0]["lr"] = xyz_lr(cfg, 2.5,
                                             optimizer_step_count(optimizer))
    optimizer.step()
    for f, leaf in zip(FIELDS, m.params.tensors()):
        ref = np.asarray(getattr(updates, f))
        got = leaf.detach().numpy()
        assert np.abs(got - ref).max() <= 1e-6, f
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=f)
        assert np.abs(ref).max() > 1e-3 * optimizer.param_groups[
            FIELDS.index(f)]["lr"]


def render_targets(scene, eyes, size=64, cfg=RasterizerConfig(
        pair_capacity=1 << 13)):
    """Port-rendered target images (3, H, W) of a sphere_scene dict."""
    a = [torch.from_numpy(scene[k]) for k in KEYS]
    with torch.no_grad():
        return [rasterize(*a, look_at_camera(e, size, size), 0,
                          cfg=cfg).image.numpy() for e in eyes]


def test_train_step_matches_jax():
    """Three steps of JAX make_train_step(impl='xla'); before each, the port
    starts from JAX's parameters, state and Adam moments and takes the same
    step: loss, applied gradients and densification stats agree."""
    scene = sphere_scene(n=150, seed=11)
    images = render_targets(scene, EYES)
    cols = np.random.default_rng(12).uniform(0.2, 0.8, size=(150, 3)).astype(
        np.float32)
    jm = jg.GaussianModel.from_point_cloud(scene["means3d"], cols,
                                           max_sh_degree=0, capacity=256,
                                           spatial_lr_scale=2.0)
    cfg = TrainConfig(sh_degree=0)
    jrcfg = JRasterizerConfig(pair_capacity=1 << 13, feat_carry_bf16=False,
                              grad_carry_bf16=False)
    rcfg = RasterizerConfig(pair_capacity=1 << 13)
    jcams = [j_look_at_camera(e, width=64, height=64) for e in EYES]
    cams = [look_at_camera(e, 64, 64) for e in EYES]
    tx = jt.make_optimizer(cfg, jm.spatial_lr_scale)
    step = jt.make_train_step(tx, jcams[0], cfg, jrcfg, 0, impl="xla",
                              max_per_tile=1024)

    @jax.jit
    def jax_grads(params, alive, camera, target):
        def loss_fn(p):
            out = jt.render_model(p, alive, camera, 0, jnp.zeros(3), jrcfg,
                                  "xla", max_per_tile=1024)
            return j_gs_loss(out.image, target, cfg.lambda_dssim)
        g = jax.grad(loss_fn)(params)
        return jax.tree.map(lambda x: jnp.where(
            alive.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0.0), g)

    params, opt, state = jm.params, tx.init(jm.params), jm.state
    bg = torch.zeros(3)
    for k in range(3):
        v = k % 2
        m = GaussianModel(params_from_numpy(np_tree(params), "cpu"), 0,
                          state_from_numpy(np_tree(state), "cpu"),
                          spatial_lr_scale=2.0)
        for leaf in m.params.tensors():
            leaf.requires_grad_(True)
        optimizer = make_optimizer(m.params, cfg, 2.0)
        if k:
            adam_state_from_numpy(optimizer, jax_adam_groups(opt))
        ref_grads = jax_grads(params, state.alive, jcams[v],
                              jnp.asarray(images[v]))
        out = train_step(m, optimizer, cams[v], torch.from_numpy(images[v]),
                         bg, cfg, rcfg, 0, 1024)
        jout = step(params, opt, state, jcams[v], jnp.asarray(images[v]),
                    jnp.zeros(3, jnp.float32))
        assert not out.overflow and not bool(jout.overflow)
        assert float(out.loss) == pytest.approx(float(jout.loss), rel=1e-5)
        for f in FIELDS:
            r = np.asarray(getattr(ref_grads, f))
            np.testing.assert_allclose(out.grads[f].numpy(), r, atol=5e-5,
                                       rtol=5e-3, err_msg=f)
        for f in ("xyz_grad_accum", "denom", "max_radii2D"):
            np.testing.assert_allclose(getattr(m.state, f).numpy(),
                                       np.asarray(getattr(jout.state, f)),
                                       rtol=5e-3, atol=5e-5, err_msg=f)
        assert int(optimizer.state[m.params.xyz]["step"]) == k + 1
        params, opt, state = jout.params, jout.opt_state, jout.state
    assert np.abs(np.asarray(state.xyz_grad_accum)).max() > 0


def make_trainer(n=120, capacity=128, seed=9, eyes=EYES[:1], rcfg=None,
                 max_per_tile=1024, **cfg_kw):
    scene = sphere_scene(n=n, seed=seed)
    images = render_targets(scene, eyes)
    cols = np.random.default_rng(seed).uniform(0.2, 0.8, size=(n, 3)).astype(
        np.float32)
    model = GaussianModel.from_point_cloud(scene["means3d"], cols,
                                           max_sh_degree=0,
                                           capacity=capacity, device="cpu")
    cfg = TrainConfig(sh_degree=0, **cfg_kw)
    return Trainer(model=model, cameras=[look_at_camera(e, 64, 64)
                                         for e in eyes],
                   images=images, cfg=cfg,
                   rcfg=rcfg or RasterizerConfig(pair_capacity=1 << 12),
                   max_per_tile=max_per_tile, scene_extent=2.0, seed=3,
                   device="cpu")


def test_training_overfits_synthetic_scene():
    """Mirror of test_model_train.py::test_training_overfits_synthetic_scene:
    from noisy points, 60 iterations with two densifications raise the PSNR
    against the targets."""
    scene = sphere_scene(n=200, seed=5)
    eyes = [(0, 0, -3.0), (0.3, 0.2, -2.9), (-0.4, 0.1, -2.8)]
    rng = np.random.default_rng(6)
    pts = scene["means3d"] + rng.normal(scale=0.05, size=(200, 3)).astype(
        np.float32)
    cols = rng.uniform(0.2, 0.8, size=(200, 3)).astype(np.float32)
    tr = Trainer(model=GaussianModel.from_point_cloud(
        pts, cols, max_sh_degree=0, capacity=512, device="cpu"),
        cameras=[look_at_camera(e, 64, 64) for e in eyes],
        images=render_targets(scene, eyes),
        cfg=TrainConfig(iterations=60, densify_from_iter=20,
                        densify_until_iter=50, densification_interval=25,
                        opacity_reset_interval=10_000, sh_degree=0),
        rcfg=RasterizerConfig(pair_capacity=1 << 13), max_per_tile=1024,
        scene_extent=2.0, device="cpu")
    psnr0 = tr.report_psnr()
    tr.train(60)
    psnr1 = tr.report_psnr()
    assert np.isfinite(psnr1) and psnr1 > psnr0 + 0.5, (psnr0, psnr1)
    assert tr.model.num_alive() > 200


def test_train_step_profiler_ranges():
    """Each taken step runs its stages in the profiler ranges
    "train_step.<stage>", and chip_smoke.py's per-stage split reads them."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from gs2mesh_torch.train.trainer import STEP_STAGES

    tr = make_trainer()
    tr.train(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(2)
    names = [e.name for e in prof.events()]
    for stage in STEP_STAGES:
        assert names.count(f"train_step.{stage}") == 2, stage
    host, dev = chip_smoke.step_stages(prof, 2)
    assert all(host[s] > 0 for s in STEP_STAGES), host
    assert not any(dev.values()), dev          # no device on the CPU


def test_trainer_capacity_growth():
    """Mirror of test_model_train.py::test_trainer_capacity_growth: direct
    growth keeps alive rows and Adam moments and pads both; densify-driven
    growth doubles the capacity on cadence."""
    cadence = dict(iterations=40, densify_from_iter=5, densify_until_iter=40,
                   densification_interval=10, opacity_reset_interval=10_000,
                   densify_grad_threshold=1e-9)
    tr = make_trainer(**cadence)
    tr.train(2)
    alive0 = tr.model.num_alive()
    xyz0 = tr.model.params.xyz.detach().clone()
    st0 = {k: v.clone() for k, v in
           tr.optimizer.state[tr.model.params.xyz].items()}
    tr.grow_capacity(256)
    assert tr.model.capacity == 256 and tr.model.num_alive() == alive0
    assert torch.equal(tr.model.params.xyz[:128].detach(), xyz0)
    st = tr.optimizer.state[tr.model.params.xyz]
    assert st["exp_avg"].shape[0] == 256 and torch.equal(st["step"],
                                                         st0["step"])
    assert torch.equal(st["exp_avg"][:128], st0["exp_avg"])
    assert not st["exp_avg_sq"][128:].any()
    tr.train(2)                          # steps at the new capacity

    tr2 = make_trainer(**cadence)        # 120/128 alive > 0.9: doubles
    tr2.train(12)
    assert tr2.model.capacity >= 256, tr2.model.capacity
    assert np.isfinite(tr2.report_psnr())


def test_checkpoint_roundtrip(tmp_path):
    """Mirror of test_model_train.py::test_checkpoint_roundtrip: params,
    Adam moments and iteration round-trip, the restoring trainer adopts the
    saved capacity, and training continues identically."""
    def make():
        return make_trainer(n=60, capacity=64, seed=11, iterations=10,
                            densify_from_iter=10_000)

    tr = make()
    tr.train(5)
    tr.save_checkpoint(str(tmp_path))
    assert os.path.exists(tmp_path / "point_cloud" / "iteration_5" /
                          "point_cloud.ply")
    tr2 = make()
    tr2.grow_capacity(128)
    tr2.restore_checkpoint(str(tmp_path), 5)
    assert tr2.iteration == 5 and tr2.model.capacity == 64
    np.testing.assert_allclose(tr2.model.params.xyz.detach().numpy(),
                               tr.model.params.xyz.detach().numpy(),
                               atol=1e-6)
    for g1, g2 in zip(tr.optimizer.param_groups, tr2.optimizer.param_groups):
        s1 = tr.optimizer.state[g1["params"][0]]
        s2 = tr2.optimizer.state[g2["params"][0]]
        for k in s1:
            assert torch.equal(s1[k], s2[k]), (g1["name"], k)
    tr.train(2)
    tr2.train(2)
    np.testing.assert_allclose(tr2.model.params.xyz.detach().numpy(),
                               tr.model.params.xyz.detach().numpy(),
                               atol=1e-6)


def test_trainer_overflow_grow_and_redo():
    """Mirror of test_model_train.py::test_trainer_overflow_grow_and_redo:
    with a tiny pair capacity and per-tile bound, overflowed renders take no
    step, both bounds grow, the iteration is redone, and the run ends at
    the same parameters as one with ample bounds."""
    kw = dict(n=150, capacity=256, seed=11, eyes=EYES,
              densify_from_iter=10_000)
    ref = make_trainer(rcfg=RasterizerConfig(pair_capacity=1 << 13),
                       max_per_tile=1024, **kw).train(6)
    tiny = make_trainer(rcfg=RasterizerConfig(pair_capacity=256),
                        max_per_tile=4, **kw).train(6)
    assert tiny.rcfg.pair_capacity > 256 and tiny.max_per_tile > 4
    assert tiny.iteration == ref.iteration == 6
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tiny.model.params, f).detach(),
                                   getattr(ref.model.params, f).detach(),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tiny.model.state.xyz_grad_accum,
                               ref.model.state.xyz_grad_accum, atol=1e-5)
    assert optimizer_step_count(tiny.optimizer) == 6
    assert optimizer_step_count(ref.optimizer) == 6


def test_gs_train_on_written_scene(tmp_path):
    """gs_train end to end on a tiny written scene (binary COLMAP model with
    points3D, PNG images): trains, writes cfg_args, the PLY and the
    checkpoint."""
    from gs2mesh_torch.cli.gs_tools import gs_train
    from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz

    scene = sphere_scene(n=80, seed=2)
    eyes = EYES + [(-0.3, 0.2, -2.9)]
    src = tmp_path / "scene"
    os.makedirs(src / "images")
    imgs = {}
    for i, (e, img) in enumerate(zip(eyes, render_targets(scene, eyes))):
        cam = look_at_camera(e, 64, 64)
        w2v = cam.world_view.numpy().T.astype(np.float64)
        imgs[i + 1] = colmap_io.ColmapImage(
            i + 1, rotmat2qvec_wxyz(w2v[:3, :3]), w2v[:3, 3], 1,
            f"{i:03}.png", np.zeros((0, 2)), np.zeros((0,), np.int64))
        write_png(str(src / "images" / f"{i:03}.png"),
                  (np.clip(img, 0, 1) * 255).round().astype(
                      np.uint8).transpose(1, 2, 0))
    f = float(cam.focal_x)
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", 64, 64,
                                      np.array([f, f, 32.0, 32.0]))}
    empty = np.zeros((0,), np.int64)
    pts = {i + 1: colmap_io.ColmapPoint3D(i + 1, p.astype(np.float64),
                                          np.array([128, 100, 90]), 0.0,
                                          empty, empty)
           for i, p in enumerate(scene["means3d"])}
    colmap_io.write_model_binary(str(src / "sparse" / "0"), cams, imgs, pts)
    out = tmp_path / "model"
    tr = gs_train(str(src), str(out), iterations=3, save_iterations=(3,),
                  quiet=True, device="cpu")
    assert tr.iteration == 3 and tr.model.num_alive() == 80
    assert os.path.exists(out / "cfg_args")
    assert os.path.exists(out / "chkpnt3.pt")
    back = GaussianModel.load_ply(
        str(out / "point_cloud" / "iteration_3" / "point_cloud.ply"), 3,
        device="cpu")
    assert back.capacity == 80
    # The network GUI listens (on a free port) and training goes on with
    # no client attached.
    tr = gs_train(str(src), str(out), iterations=1, gui=True, port=0,
                  quiet=True, device="cpu")
    assert tr.iteration == 1


def test_entry_points_default_to_cuda(tmp_path):
    """Without device=..., the entry points ask for CUDA and raise where
    there is none (never a silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    from gs2mesh_torch.cli.gs_tools import gs_train
    from gs2mesh_torch.train.scene import load_colmap_scene

    pts, cols = point_cloud(10, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        GaussianModel.from_point_cloud(pts, cols)
    model = GaussianModel.from_point_cloud(pts, cols, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(model=model, cameras=[], images=[])
    with pytest.raises(RuntimeError, match="cuda"):
        load_colmap_scene(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        gs_train(str(tmp_path), str(tmp_path / "m"))
    assert dataclasses.fields(Trainer)[-1].default == "cuda"
