"""Standalone GS tooling: train / render / metrics / full_eval, the port of
gs2mesh_tpu cli/gs_tools.py (the reference gaussian-splatting root scripts):

  gs_train     <- train.py (the port's trainer, cfg_args persistence)
  gs_render    <- render.py:24-65 (train / test sets to PNG)
  gs_metrics   <- metrics.py (PSNR / SSIM / LPIPS over the renders)
  gs_full_eval <- full_eval.py (train + render + metrics over scenes)

    python -m gs2mesh_torch.cli.gs_tools train|render|metrics ...

Every function runs on ``device`` (the card unless the caller asks for the
CPU); PNGs are read and written by ``core/png.py``. ``gs_train(gui=True)``
(``train --gui``) serves the SIBR remote viewer on ``ip:port`` between
steps (``train/network_gui.py``).
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser, Namespace
from typing import Optional

import numpy as np
import torch


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
             ip: str = "127.0.0.1", port: int = 6009,
             gui: bool = False, device="cuda"):
    """Train a GS model on a COLMAP scene and save checkpoints to
    ``model_path``. With ``gui`` a SIBR remote viewer may attach on
    ``ip:port`` and is served a frame between steps. Returns the Trainer."""
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.train.scene import (load_colmap_scene,
                                           random_point_cloud_fallback)
    from gs2mesh_torch.train.trainer import TrainConfig, Trainer

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

    net_gui = None
    if gui:
        from gs2mesh_torch.train.network_gui import NetworkGUI

        try:
            net_gui = NetworkGUI(ip, port)
        except OSError as e:
            print(f"network_gui disabled: {e}")

    test_set = set(test_iterations)
    save_set = set(save_iterations) | {iterations}

    def cb(tr, out):
        it = tr.iteration
        if net_gui is not None:
            from gs2mesh_torch.train.network_gui import serve_step
            from gs2mesh_torch.train.trainer import render_model

            def render_fn(cam, scaling):
                return render_model(
                    tr.model.params, tr.model.state.alive, cam,
                    tr.model.active_sh_degree,
                    torch.zeros(3, dtype=torch.float32, device=tr.device),
                    tr.rcfg, max_per_tile=tr.max_per_tile,
                    scale_modifier=float(scaling)).image

            serve_step(net_gui, render_fn, it, cfg.iterations, source_path,
                       device=tr.device)
        if it in test_set and scene.test_indices and not quiet:
            # training_report equivalent (train.py:156-191)
            value = tr.report_psnr(range(min(5, len(tr.cameras))))
            print(f"[ITER {it}] train PSNR {value:.2f}")
        if it in save_set:
            print(f"[ITER {it}] Saving Gaussians")
            tr.save_checkpoint(model_path)

    try:
        trainer.train(log_every=0 if quiet else 500, callback=cb)
    finally:
        if net_gui is not None:
            net_gui.close()
    return trainer


def gs_render(model_path: str, source_path: Optional[str] = None,
              iteration: int = -1, skip_train: bool = False,
              skip_test: bool = False, resolution: int = -1,
              device="cuda") -> None:
    """Render the train / test sets to <set>/ours_<it>/{renders,gt}/NNNNN.png
    (render.py:24-65). A render that overflows its pair capacity raises."""
    from gs2mesh_torch.core.png import write_png
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
    from gs2mesh_torch.train.scene import load_colmap_scene

    if iteration == -1:
        pc_dir = os.path.join(model_path, "point_cloud")
        iteration = max(int(d.split("_")[1]) for d in os.listdir(pc_dir))
    model = GaussianModel.load_ply(os.path.join(
        model_path, "point_cloud", f"iteration_{iteration}",
        "point_cloud.ply"), device=device)
    inputs = model.raster_inputs()
    cfg = RasterizerConfig(pair_capacity=1 << 22)
    scene = load_colmap_scene(source_path or model_path,
                              resolution=resolution, eval_split=True,
                              device=device)
    sets = []
    if not skip_train:
        sets.append(("train", scene.train_indices))
    if not skip_test:
        sets.append(("test", scene.test_indices))
    for name, indices in sets:
        rdir = os.path.join(model_path, name, f"ours_{iteration}", "renders")
        gdir = os.path.join(model_path, name, f"ours_{iteration}", "gt")
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        for n, i in enumerate(indices):
            with torch.no_grad():
                out = rasterize(inputs["means3d"], inputs["scales"],
                                inputs["rotations"], inputs["opacities"],
                                inputs["shs"], scene.cameras[i],
                                model.max_sh_degree, cfg=cfg)
            if bool(out.overflow) or bool(out.tile_overflow):
                raise RuntimeError(
                    f"{name} view {i}: {int(out.num_pairs)} pairs overflow "
                    f"the pair capacity {cfg.pair_capacity}")
            img = np.clip(out.image.cpu().numpy(), 0, 1)
            write_png(os.path.join(rdir, f"{n:05}.png"),
                      (img.transpose(1, 2, 0) * 255).astype(np.uint8))
            write_png(os.path.join(gdir, f"{n:05}.png"),
                      (scene.images[i].transpose(1, 2, 0) * 255).astype(
                          np.uint8))


def gs_metrics(model_paths, lpips: bool = False, device="cuda") -> dict:
    """Mean SSIM / PSNR (/ LPIPS) of every test method's renders against
    their gt (metrics.py); writes <model_path>/results.json."""
    from gs2mesh_torch import resolve_device
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.ops.ssim import psnr, ssim

    dev = resolve_device(device)

    def load(path):
        img = read_png(path)[..., :3].astype(np.float32).transpose(2, 0, 1)
        return torch.from_numpy(img / 255.0).to(dev)

    results = {}
    for model_path in np.atleast_1d(model_paths):
        per_method = {}
        test_dir = os.path.join(model_path, "test")
        methods = (sorted(os.listdir(test_dir))
                   if os.path.isdir(test_dir) else [])
        for method in methods:
            rdir = os.path.join(test_dir, method, "renders")
            gdir = os.path.join(test_dir, method, "gt")
            ssims, psnrs, lpipss = [], [], []
            for fname in sorted(os.listdir(rdir)):
                r = load(os.path.join(rdir, fname))
                g = load(os.path.join(gdir, fname))
                ssims.append(float(ssim(r, g)))
                psnrs.append(float(psnr(r, g)))
                if lpips:
                    lpipss.append(_lpips(r, g))
            per_method[method] = {"SSIM": float(np.mean(ssims)),
                                  "PSNR": float(np.mean(psnrs))}
            if lpips:
                per_method[method]["LPIPS"] = float(np.mean(lpipss))
        results[model_path] = per_method
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(per_method, f, indent=2)
        print(model_path, per_method)
    return results


_lpips_nets: dict = {}


def _lpips(img_a: torch.Tensor, img_b: torch.Tensor) -> float:
    """LPIPS of two (3, H, W) images in [0, 1] on their device. The weights
    load from the GS2MESH_LPIPS_VGG (torchvision VGG16 features state dict)
    and GS2MESH_LPIPS_LIN (LPIPS v0.1 vgg linear heads) files, as in the
    JAX package."""
    from gs2mesh_torch.metrics import (convert_lpips_checkpoint, load_lpips,
                                       lpips)

    vgg = os.environ.get("GS2MESH_LPIPS_VGG", "")
    lin = os.environ.get("GS2MESH_LPIPS_LIN", "")
    if not (vgg and os.path.exists(vgg) and lin and os.path.exists(lin)):
        raise FileNotFoundError(
            "LPIPS weights not found: set GS2MESH_LPIPS_VGG (torchvision "
            "vgg16 features state_dict) and GS2MESH_LPIPS_LIN (LPIPS "
            "v0.1 vgg linear heads), or run gs_metrics(lpips=False).")
    key = (vgg, lin, img_a.device)
    if key not in _lpips_nets:
        _lpips_nets[key] = load_lpips(convert_lpips_checkpoint(vgg, lin),
                                      img_a.device)
    with torch.no_grad():
        return float(lpips(_lpips_nets[key], img_a[None], img_b[None])[0])


def gs_full_eval(source_paths, output_base: str, iterations=(7000, 30000),
                 white_background: bool = False, device="cuda") -> dict:
    """Train, render the test views and score them, scene by scene
    (full_eval.py)."""
    results = {}
    for src in source_paths:
        name = os.path.basename(os.path.normpath(src))
        model_path = os.path.join(output_base, name)
        gs_train(src, model_path, iterations=max(iterations),
                 save_iterations=list(iterations),
                 white_background=white_background, eval_split=True,
                 quiet=True, device=device)
        for it in iterations:
            gs_render(model_path, src, iteration=it, skip_train=True,
                      device=device)
        results.update(gs_metrics([model_path], device=device))
    return results


def main(argv=None):
    parser = ArgumentParser(description="GS tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("-s", "--source_path", required=True)
    t.add_argument("-m", "--model_path", required=True)
    t.add_argument("--iterations", type=int, default=30000)
    t.add_argument("--test_iterations", type=int, nargs="+",
                   default=[7000, 30000])
    t.add_argument("--save_iterations", type=int, nargs="+",
                   default=[7000, 30000])
    t.add_argument("--white_background", action="store_true")
    t.add_argument("--eval", action="store_true")
    t.add_argument("--port", type=int, default=6009)
    t.add_argument("--gui", action="store_true")
    r = sub.add_parser("render")
    r.add_argument("-m", "--model_path", required=True)
    r.add_argument("-s", "--source_path", default=None)
    r.add_argument("--iteration", type=int, default=-1)
    r.add_argument("--skip_train", action="store_true")
    r.add_argument("--skip_test", action="store_true")
    m = sub.add_parser("metrics")
    m.add_argument("-m", "--model_paths", nargs="+", required=True)
    m.add_argument("--lpips", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "train":
        gs_train(args.source_path, args.model_path, args.iterations,
                 args.test_iterations, args.save_iterations,
                 args.white_background, eval_split=args.eval,
                 port=args.port, gui=args.gui)
    elif args.cmd == "render":
        gs_render(args.model_path, args.source_path, args.iteration,
                  args.skip_train, args.skip_test)
    elif args.cmd == "metrics":
        gs_metrics(args.model_paths, lpips=args.lpips)


if __name__ == "__main__":
    main()
