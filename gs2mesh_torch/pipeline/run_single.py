"""Pipeline orchestrator: the 7-stage gs2mesh run.

Port of gs2mesh_tpu pipeline/run_single.py (the reference run_single.py:
26-180). GS training runs in-process on the port's trainer (the reference
shells out to `python train.py`) with the same checkpoint layout
(splatting_output/<splatting>/<name>/point_cloud/iteration_N/
point_cloud.ply), and the stages hand off through the reference's on-disk
layout, so every inter-stage artifact is a resume point. Every stage runs on
``device`` (the card unless the caller asks for the CPU), each in a
``record_function`` range named in RUN_STAGES ("run_single.<name>").

Differences from the JAX orchestrator: the stereo stage takes a DLNR module
(``stereo_model``), not a parameter pytree; multi-device GS training
(``GS_devices > 1``) runs one process per card under ``torchrun
--nproc-per-node <GS_devices>`` (the JAX package drives every device from
one process): rank 0 alone runs the stages before and after training, the
others train and return None; the custom
dataset's automask finds the reference's SAM2 checkpoint path under
``base_dir`` (``masker_stage.init_predictor``; JAX's passes none and
raises); the dataset masks are read with the port's PNG reader (8-bit gray,
RGB or RGBA; a palette or 1-bit PNG raises).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
from torch.profiler import record_function

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.masker_stage import CopyMasker, init_predictor
from gs2mesh_torch.pipeline.renderer_stage import Renderer
from gs2mesh_torch.pipeline.stereo_stage import Stereo
from gs2mesh_torch.pipeline.strings import create_strings
from gs2mesh_torch.pipeline.tsdf_stage import TSDF

RUN_STAGES = ("sfm", "train_gs", "render_stereo", "mask", "tsdf_run",
              "tsdf_save", "tsdf_clean")


def train_gs(colmap_dir: str, model_dir: str, iterations: int,
             save_iterations, white_background: bool,
             resolution: int = -1, max_views=None,
             capacity=None, log_every: int = 500,
             pair_capacity: int = 1 << 22, devices: int = 1,
             device="cuda"):
    """In-process GS training stage (replaces the train.py subprocess):
    trains gs_trainer's trainer on every view of the scene and saves the
    GS PLY and checkpoint at each of ``save_iterations`` and at the last
    iteration. With ``devices > 1`` every rank of an initialised process
    group of that size calls it, and a ShardedTrainer trains on a
    (1, devices) mesh."""
    trainer = gs_trainer(colmap_dir, iterations, white_background,
                         resolution, max_views, capacity, pair_capacity,
                         devices, device)
    save_set = set(save_iterations or [iterations])
    save_set.add(iterations)

    def cb(tr, out):
        if tr.iteration in save_set:
            tr.save_checkpoint(model_dir)

    trainer.train(log_every=log_every, callback=cb)
    return trainer


def gs_trainer(colmap_dir: str, iterations: int, white_background: bool,
               resolution: int = -1, max_views=None, capacity=None,
               pair_capacity: int = 1 << 22, devices: int = 1,
               device="cuda"):
    """The GS stage's untrained trainer: load_colmap_scene ->
    GaussianModel.from_point_cloud -> Trainer (ShardedTrainer with
    ``devices > 1``) with TrainConfig's schedule for ``iterations``."""
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig
    from gs2mesh_torch.train.scene import (load_colmap_scene,
                                           random_point_cloud_fallback)
    from gs2mesh_torch.train.trainer import TrainConfig, Trainer

    if devices > 1:
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != devices:
            raise ValueError(
                f"GS_devices={devices} trains one process per card: launch "
                f"with torchrun --nproc-per-node {devices} (the process "
                f"group must be initialised with {devices} ranks)")
    scene = load_colmap_scene(colmap_dir, resolution=resolution,
                              max_views=max_views, device=device)
    xyz, rgb = scene.points, scene.colors
    if xyz.shape[0] == 0:
        xyz, rgb = random_point_cloud_fallback(100_000,
                                               scene.nerf_norm_radius)
    if devices > 1 and capacity is None:
        # Rows split evenly over the gauss axis.
        capacity = -(-max(xyz.shape[0], 4096) // (4096 * devices)) \
            * 4096 * devices
    model = GaussianModel.from_point_cloud(
        xyz, rgb, capacity=capacity,
        spatial_lr_scale=scene.nerf_norm_radius, device=device)
    cfg = TrainConfig(iterations=iterations,
                      white_background=white_background)
    rcfg = RasterizerConfig(pair_capacity=pair_capacity)
    if devices > 1:
        from gs2mesh_torch.parallel import ShardedTrainer, make_mesh

        trainer = ShardedTrainer(
            mesh=make_mesh(1, devices, model.device.type), model=model,
            cameras=scene.cameras, images=scene.images, cfg=cfg, rcfg=rcfg,
            scene_extent=scene.nerf_norm_radius)
    else:
        trainer = Trainer(model=model, cameras=scene.cameras,
                          images=scene.images, cfg=cfg, rcfg=rcfg,
                          scene_extent=scene.nerf_norm_radius, device=device)
    return trainer


def _mask_files(masks_dir: str, skip_hidden: bool):
    return sorted(f for f in os.listdir(masks_dir)
                  if os.path.isfile(os.path.join(masks_dir, f))
                  and not (skip_hidden and f.startswith(".")))


def _read_mask(path: str) -> np.ndarray:
    mask = read_png(path).astype(np.float32)
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    return mask


def dtu_mask_loader(colmap_dir: str, renderer):
    """DTU dataset mask copy with the principal-point crop
    (run_single.py:119-136)."""
    masks_dir = os.path.join(colmap_dir, "mask")
    files = _mask_files(masks_dir, skip_hidden=True)

    def load(i):
        mask = _read_mask(os.path.join(masks_dir, files[i]))
        mask = mask / max(mask.max(), 1e-9)
        cx, cy = 823.204, 619.071
        H, W = mask.shape
        W2 = min(W - cx, cx)
        H2 = min(H - cy, cy)
        return mask[int(cy - H2):int(cy + H2),
                    int(cx - W2):int(cx + W2)] > 0.5

    return load


def mobilebrick_mask_loader(colmap_dir: str, renderer):
    masks_dir = os.path.join(colmap_dir, "mask")
    files = _mask_files(masks_dir, skip_hidden=False)

    def load(i):
        mask = _read_mask(os.path.join(masks_dir, files[i]))
        return mask / max(mask.max(), 1e-9) > 0.5

    return load


def run_single(args: PipelineArgs, base_dir: str | None = None,
               stereo_model=None, stereo_ckpt: str | None = None,
               gs_max_views=None, gs_resolution: int = -1,
               pair_capacity: int = 1 << 22,
               stereo_iters: int | None = None,
               device="cuda") -> str | None:
    """Run the full pipeline for one scene; returns the cleaned-mesh path.
    Like the JAX orchestrator it updates ``args`` in place: colmap_name
    gains "_downsample<k>" when downsampling (the dataset drivers read it
    back). With ``GS_devices > 1`` every rank calls it; rank 0 runs every
    stage, the other ranks only train and return None."""
    from gs2mesh_torch.sfm import (create_downsampled_colmap_dir,
                                   extract_frames, run_colmap)

    device = resolve_device(device)
    base_dir = os.path.abspath(base_dir or os.getcwd())
    colmap_dir = os.path.abspath(os.path.join(
        base_dir, "data", args.dataset_name, args.colmap_name))
    strings = create_strings(args, base_dir)
    sharded = args.GS_devices > 1 and not args.skip_GS
    lead = True
    if sharded:
        import torch.distributed as dist

        lead = not dist.is_initialized() or dist.get_rank() == 0

    with record_function("run_single.sfm"):
        # --- stage: video frame extraction -------------------------------
        if not args.skip_video_extraction and lead:
            video = f"{args.colmap_name}.{args.video_extension}"
            extract_frames(os.path.join(colmap_dir, video),
                           os.path.join(colmap_dir, "images"),
                           interval=args.video_interval)

        # --- stage: downsample --------------------------------------------
        if args.downsample > 1:
            if lead:
                create_downsampled_colmap_dir(colmap_dir, args.downsample)
            args.colmap_name = (f"{args.colmap_name}_downsample"
                                f"{args.downsample}")
            colmap_dir = os.path.abspath(os.path.join(
                base_dir, "data", args.dataset_name, args.colmap_name))
            strings = create_strings(args, base_dir)

        # --- stage: COLMAP --------------------------------------------------
        if not args.skip_colmap and lead:
            run_colmap(colmap_dir)
        if sharded and dist.is_initialized():
            dist.barrier()              # the scene is on disk for every rank

    # --- stage: GS training ---------------------------------------------
    model_dir = os.path.join(base_dir, "splatting_output",
                             strings["splatting"], args.colmap_name)
    if not args.skip_GS:
        with record_function("run_single.train_gs"):
            train_gs(colmap_dir, model_dir, args.GS_iterations,
                     args.GS_save_test_iterations, args.GS_white_background,
                     resolution=gs_resolution, max_views=gs_max_views,
                     pair_capacity=pair_capacity, devices=args.GS_devices,
                     device=device)
    if not lead:
        return None

    # --- stage: renderer + stereo ---------------------------------------
    with record_function("run_single.render_stereo"):
        renderer = Renderer(base_dir, colmap_dir, strings["output_dir_root"],
                            args, dataset=strings["dataset"],
                            splatting=strings["splatting"],
                            experiment_name=strings["experiment_name"],
                            device=device)
        if not args.skip_rendering:
            renderer.prepare_renderer(pair_capacity=pair_capacity)

        stereo = Stereo(base_dir, renderer, args, model=stereo_model,
                        ckpt_path=stereo_ckpt, device=device)
        if stereo_iters is not None:                 # test/bench knob
            stereo.cfg = dataclasses.replace(stereo.cfg, iters=stereo_iters)
        if not args.skip_rendering:
            stereo.run(start=0)

    # --- stage: masking --------------------------------------------------
    if not args.skip_masking:
        with record_function("run_single.mask"):
            if args.dataset_name == "custom":
                if args.masker_automask:
                    init_predictor(base_dir, renderer, args,
                                   device=device).segment()
                    args.TSDF_use_mask = True
                else:
                    print("Automask must be enabled for masking in script "
                          "mode. Skipping.")
            elif args.dataset_name == "DTU":
                CopyMasker(renderer, dtu_mask_loader(colmap_dir,
                                                     renderer)).segment()
            elif args.dataset_name == "MobileBrick":
                CopyMasker(renderer, mobilebrick_mask_loader(
                    colmap_dir, renderer)).segment()

    # --- stage: TSDF ------------------------------------------------------
    tsdf = TSDF(renderer, stereo, args, strings["TSDF"], device=device)
    if not args.skip_TSDF:
        with record_function("run_single.tsdf_run"):
            tsdf.run()
        with record_function("run_single.tsdf_save"):
            tsdf.save_mesh()
        with record_function("run_single.tsdf_clean"):
            tsdf.clean_mesh()

    return os.path.join(renderer.output_dir_root,
                        f"{tsdf.out_name}_cleaned_mesh.ply")
