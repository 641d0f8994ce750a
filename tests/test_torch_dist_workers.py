"""Process bodies of the port's multi-rank CPU tests (gloo).

``run`` is the spawn target: it initialises a gloo process group from a
file store, calls one worker with (rank, out_dir, *args) and writes a
traceback file on failure. The workers import torch and the port only, so
the spawned processes never load JAX; they write their results with
``torch.save`` as <out_dir>/<name>_rank<r>.pt.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist


def run(fn, rank: int, world: int, store: str, out_dir: str, args,
        env=None):
    torch.set_num_threads(1)
    try:
        if env is None:
            dist.init_process_group("gloo", init_method=f"file://{store}",
                                    world_size=world, rank=rank)
        else:
            os.environ.update(env)
            os.environ["RANK"] = str(rank)
        fn(rank, out_dir, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def save(out_dir: str, name: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def _model(init):
    from gs2mesh_torch.models.gaussians import (GaussianModel,
                                                params_from_numpy,
                                                state_from_numpy)

    return GaussianModel(params_from_numpy(init["params"], "cpu"),
                         max_sh_degree=init["max_sh_degree"],
                         state=state_from_numpy(init["state"], "cpu"),
                         spatial_lr_scale=init["spatial_lr_scale"])


def _numpy_model(model):
    return {"params": {f: t.detach().numpy().copy() for f, t in
                       zip(("xyz", "features_dc", "features_rest", "scaling",
                            "rotation", "opacity"),
                           model.params.tensors())},
            "state": {k: v.numpy().copy()
                      for k, v in dataclasses.asdict(model.state).items()}}


def sharded_step(rank, out_dir, D, G, init, cams, targets, cfg, rcfg):
    """One sharded step on a (D, G) mesh, data row d on view d; the whole
    model after it, the loss, the slice pair counts, and the sharded loss
    beside gs_loss on the stitched image (both before the step)."""
    from gs2mesh_torch.ops.ssim import gs_loss
    from gs2mesh_torch.parallel import (ShardedTrainer, make_mesh,
                                        rasterize_sharded, sharded_gs_loss,
                                        sharded_train_step)
    from gs2mesh_torch.parallel.mesh import all_gather_rows, mesh_coords
    from gs2mesh_torch.parallel.sharded_train import stitch_slices

    mesh = make_mesh(D, G, "cpu")
    d, g = mesh_coords(mesh)
    tr = ShardedTrainer(mesh=mesh, model=_model(init), cameras=cams,
                        images=targets, cfg=cfg, rcfg=rcfg)
    cam, target = cams[d], torch.from_numpy(targets[d])
    gauss = mesh.get_group("gauss")
    bg = torch.zeros(3)
    with torch.no_grad():
        r = rasterize_sharded(tr.model.params, tr.model.state.alive, cam, 0,
                              bg, rcfg, gauss)
        total, _ = sharded_gs_loss(r.image_slice, r.row_valid, target, g,
                                   cam.height, cam.width, rcfg.tile,
                                   cfg.lambda_dssim, G, gauss)
        slices = all_gather_rows(r.image_slice[None].contiguous(), gauss)
        stitched = stitch_slices(list(slices), cam.height, rcfg.tile)
        loss_stitched = gs_loss(stitched, target, cfg.lambda_dssim)
    out = sharded_train_step(tr.model, tr.optimizer, mesh, cam, target, bg,
                             cfg, rcfg, 0)
    full, _ = tr.gather_model()
    save(out_dir, "step", rank, dict(
        loss=float(out.loss), pairs=out.pairs_per_device.numpy(),
        overflow=out.overflow, model=_numpy_model(full),
        sharded_loss=float(total), stitched_loss=float(loss_stitched),
        stitched=stitched.numpy()))


def tall_slices(rank, out_dir, G, image, target, init, cam, rcfg,
                lambda_dssim):
    """On a (1, G) mesh: the sharded loss of ``image``'s slice against
    ``target`` and its gradient for the slice, then the sharded render of
    the model through ``cam`` stitched from every slice."""
    from gs2mesh_torch.parallel import (ShardedTrainer, make_mesh,
                                        rasterize_sharded, sharded_gs_loss)
    from gs2mesh_torch.parallel.mesh import all_gather_rows, mesh_coords
    from gs2mesh_torch.parallel.sharded_train import (image_slice,
                                                      row_valid_mask,
                                                      slice_rows,
                                                      stitch_slices)

    mesh = make_mesh(1, G, "cpu")
    gauss = mesh.get_group("gauss")
    _, ax = mesh_coords(mesh)
    height, width = target.shape[1:]
    rows_per, h_slice = slice_rows(height, rcfg, G)
    img = image_slice(torch.from_numpy(image), G, ax, h_slice,
                      rcfg.tile).requires_grad_(True)
    # Zero past the image's height, as rasterize_sharded gives it.
    row_valid = row_valid_mask(h_slice, rcfg.tile, ax, G, height, "cpu")
    total, partial = sharded_gs_loss(
        img * row_valid[None], row_valid, torch.from_numpy(target), ax,
        height, width, rcfg.tile, lambda_dssim, G, gauss)
    (grad,) = torch.autograd.grad(partial, img)
    tr = ShardedTrainer(mesh=mesh, model=_model(init), cameras=[cam],
                        images=[target], rcfg=rcfg)
    with torch.no_grad():
        r = rasterize_sharded(tr.model.params, tr.model.state.alive, cam, 0,
                              torch.zeros(3), rcfg, gauss)
        slices = all_gather_rows(r.image_slice[None].contiguous(), gauss)
    save(out_dir, "tall", rank, dict(
        rows_per=rows_per, loss=float(total), grad=grad.numpy(),
        num_pairs=int(r.num_pairs),
        stitched=stitch_slices(list(slices), height, rcfg.tile).numpy()))


def _record_densify(records):
    """Wraps train.trainer.densify_and_prune (both trainers call it there)
    to keep each call's result: the rows, the alive mask, the returned
    max_radii2D, and (max_screen_size, n_prune, the alive rows under the
    opacity cull or, with the size prune on, over a tenth of the extent)."""
    from gs2mesh_torch.train import trainer

    inner = trainer.densify_and_prune

    def wrapper(params, state, optimizer, extent, dcfg, gen):
        under = torch.sigmoid(params.opacity[:, 0]) < dcfg.opacity_cull
        if dcfg.max_screen_size > 0:
            under |= torch.exp(params.scaling).amax(1) > 0.1 * extent
        candidates = int((state.alive & under).sum())
        params, state, stats = inner(params, state, optimizer, extent, dcfg,
                                     gen)
        records.append([t.detach().clone() for t in params.tensors()]
                       + [state.alive.clone(), state.max_radii2D.clone(),
                          torch.tensor([dcfg.max_screen_size,
                                        stats["n_prune"], candidates])])
        return params, state, stats

    trainer.densify_and_prune = wrapper


def trainer_world(rank, out_dir, init, cams, images, cfg, rcfg, views,
                  volume_case, ckpt_dir):
    """On a (1, 2) mesh: a ShardedTrainer run with a densify and an opacity
    reset (each densify's whole-model result kept), an overflow redo from a
    tiny pair capacity, a checkpoint round trip, the G = 1 sharded loss;
    then on a (2, 1) mesh the sharded DLNR and TSDF integrate."""
    from gs2mesh_torch.ops.ssim import gs_loss
    from gs2mesh_torch.parallel import (ShardedTrainer, make_mesh,
                                        rasterize_sharded, sharded_gs_loss)

    mesh = make_mesh(1, 2, "cpu")
    records = []
    _record_densify(records)
    tr = ShardedTrainer(mesh=mesh, model=_model(init), cameras=cams,
                        images=images, cfg=cfg, rcfg=rcfg, seed=3)
    tr.train(cfg.iterations)
    full, _ = tr.gather_model()
    result = dict(alive=tr.num_alive(), densify=records,
                  model=_numpy_model(full), capacity=tr.capacity)

    small = dataclasses.replace(rcfg, pair_capacity=64)
    tr2 = ShardedTrainer(mesh=mesh, model=_model(init), cameras=cams,
                         images=images, cfg=cfg, rcfg=small, seed=3)
    tr2.train(2)
    result.update(grown_capacity=tr2.rcfg.pair_capacity,
                  grown_iteration=tr2.iteration)

    tr.save_checkpoint(ckpt_dir)
    saved, saved_moments = tr.gather_model()
    tr3 = ShardedTrainer(mesh=mesh, model=_model(init), cameras=cams,
                         images=images, cfg=cfg, rcfg=rcfg, seed=3)
    tr3.restore_checkpoint(ckpt_dir, tr.iteration)
    restored, restored_moments = tr3.gather_model()
    n = int(saved.state.alive.sum())
    alive = saved.state.alive
    result["ckpt"] = dict(
        iteration=tr3.iteration, n=n,
        params=[(a.detach()[alive].numpy(), b.detach()[:n].numpy())
                for a, b in zip(saved.params.tensors(),
                                restored.params.tensors())],
        moments=[(saved_moments[k][m][alive].numpy(),
                  restored_moments[k][m][:n].numpy())
                 for k in saved_moments for m in ("exp_avg", "exp_avg_sq")],
        restored_alive=restored.state.alive.numpy())
    tr3.train(1)
    result["ckpt"]["loss_after"] = True

    # G = 1: a group of this rank alone.
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    cam, target = cams[0], torch.from_numpy(images[0])
    with torch.no_grad():
        r = rasterize_sharded(tr.model.params, tr.model.state.alive, cam, 0,
                              torch.zeros(3), rcfg, own)
        total, _ = sharded_gs_loss(r.image_slice, r.row_valid, target, 0,
                                   cam.height, cam.width, rcfg.tile,
                                   cfg.lambda_dssim, 1, own)
        result["g1_losses"] = (float(total), float(gs_loss(
            r.image_slice[:, :cam.height], target, cfg.lambda_dssim)))

    mesh21 = make_mesh(2, 1, "cpu")
    result.update(inference(mesh21, *views, *volume_case))
    save(out_dir, "trainer", rank, result)


def inference(mesh, model_seed, images1, images2, volume_cfg, frames):
    from gs2mesh_torch.fusion.tsdf import allocate, create_volume
    from gs2mesh_torch.parallel import (gather_volume, make_sharded_dlnr,
                                        make_sharded_integrate, shard_volume)
    from gs2mesh_torch.stereo import DLNR, DLNRConfig
    from gs2mesh_torch.stereo.dlnr import init_dlnr_

    model = init_dlnr_(DLNR(), torch.Generator().manual_seed(model_seed))
    if dist.get_rank() == 1:          # the broadcast must make them equal
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    run = make_sharded_dlnr(mesh, DLNRConfig(iters=1))
    flow, disp = run(model, torch.from_numpy(images1),
                     torch.from_numpy(images2))

    shard = shard_volume(create_volume(volume_cfg, "cpu"), mesh)
    step = make_sharded_integrate(volume_cfg)
    for color, depth, K, E in frames:
        color, depth, K, E = (torch.from_numpy(x) for x in
                              (color, depth, K, E))
        shard = allocate(shard, depth, K, E, 3.0, volume_cfg)
        shard = step(shard, color, depth, K, E, 3.0)
    vol = gather_volume(shard, mesh)
    return dict(flow=flow.numpy(), disp=disp.numpy(),
                volume={k: getattr(vol, k).numpy() for k in
                        ("keys", "order", "tsdf", "weight", "color")},
                n_blocks=vol.n_blocks)


def train_gs_world(rank, out_dir, colmap_dir, model_dir):
    """train_gs(devices=2) in a world of 2."""
    from gs2mesh_torch.parallel import ShardedTrainer
    from gs2mesh_torch.pipeline.run_single import train_gs

    tr = train_gs(colmap_dir, model_dir, 3, [2], False, devices=2,
                  pair_capacity=1 << 14, log_every=0, device="cpu")
    save(out_dir, "train_gs", rank, dict(
        sharded=isinstance(tr, ShardedTrainer), iteration=tr.iteration,
        capacity=tr.capacity))


def multihost(rank, out_dir, init, cam, target, cfg, rcfg):
    """torchrun-style environment -> initialize() -> make_hybrid_mesh(2, 1,
    1) -> one sharded step."""
    from gs2mesh_torch.parallel import ShardedTrainer, sharded_train_step
    from gs2mesh_torch.parallel.multihost import (initialize,
                                                  make_hybrid_mesh,
                                                  process_local_batch)

    initialize()
    initialize()                       # idempotent
    mesh = make_hybrid_mesh(2, 1, 1, device_type="cpu")
    tr = ShardedTrainer(mesh=mesh, model=_model(init), cameras=[cam],
                        images=[target], cfg=cfg, rcfg=rcfg)
    out = sharded_train_step(tr.model, tr.optimizer, mesh, cam,
                             torch.from_numpy(target), torch.zeros(3), cfg,
                             rcfg, 0)
    save(out_dir, "multihost", rank, dict(
        loss=float(out.loss), world=dist.get_world_size(),
        backend=dist.get_backend(), local_batch=process_local_batch(4),
        xyz=tr.model.params.xyz.detach().numpy().copy(),
        mesh_shape=tuple(mesh.shape)))
