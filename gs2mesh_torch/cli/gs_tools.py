"""Standalone GS training (port of gs2mesh_tpu cli/gs_tools.py::gs_train,
the reference train.py:31-132, and save_cfg_args). Rendering, metrics and
the batch evaluation of the JAX module are not ported yet; neither is the
network GUI."""

from __future__ import annotations

import os
from argparse import Namespace


def save_cfg_args(model_path: str, source_path: str, sh_degree: int = 3,
                  white_background: bool = False) -> None:
    """Persist cfg_args like the reference (arguments/__init__.py:92-113 +
    prepare_output_and_logger, train.py:140-150)."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(sh_degree=sh_degree, source_path=source_path,
                   model_path=model_path, images="images", resolution=-1,
                   white_background=white_background, data_device="cuda",
                   eval=False)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def gs_train(source_path: str, model_path: str, iterations: int = 30000,
             test_iterations=(7000, 30000), save_iterations=(7000, 30000),
             white_background: bool = False, resolution: int = -1,
             eval_split: bool = False, quiet: bool = False,
             gui: bool = False, device="cuda"):
    """Train a GS model on a COLMAP scene and save checkpoints to
    ``model_path``. Returns the Trainer."""
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.train.scene import (load_colmap_scene,
                                           random_point_cloud_fallback)
    from gs2mesh_torch.train.trainer import TrainConfig, Trainer

    if gui:
        raise NotImplementedError("the network GUI is not ported; train "
                                  "with gui=False")
    scene = load_colmap_scene(source_path, resolution=resolution,
                              eval_split=eval_split, device=device)
    xyz, rgb = scene.points, scene.colors
    if xyz.shape[0] == 0:
        xyz, rgb = random_point_cloud_fallback(100_000,
                                               scene.nerf_norm_radius)
    model = GaussianModel.from_point_cloud(
        xyz, rgb, spatial_lr_scale=scene.nerf_norm_radius, device=device)
    cfg = TrainConfig(iterations=iterations,
                      white_background=white_background)
    trainer = Trainer(model=model,
                      cameras=[scene.cameras[i] for i in scene.train_indices],
                      images=[scene.images[i] for i in scene.train_indices],
                      cfg=cfg, scene_extent=scene.nerf_norm_radius,
                      device=device)
    save_cfg_args(model_path, source_path, white_background=white_background)

    test_set = set(test_iterations)
    save_set = set(save_iterations) | {iterations}

    def cb(tr, out):
        it = tr.iteration
        if it in test_set and scene.test_indices and not quiet:
            # training_report equivalent (train.py:156-191)
            value = tr.report_psnr(range(min(5, len(tr.cameras))))
            print(f"[ITER {it}] train PSNR {value:.2f}")
        if it in save_set:
            print(f"[ITER {it}] Saving Gaussians")
            tr.save_checkpoint(model_path)

    trainer.train(log_every=0 if quiet else 500, callback=cb)
    return trainer
