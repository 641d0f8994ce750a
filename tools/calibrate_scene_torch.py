"""The bench scene's pair load against a trained model's, for the PyTorch
port on one CUDA card.

The port's counterpart of tools/calibrate_scene.py. The bench sphere
(300k gaussians, the draws of __graft_entry__._scene) is the ground truth
of 24 ring views at 960x576; the port's Trainer fits a model to them from
a 30k-point shell with full densification, and the tool reports that
TRAINED model's emission statistics on the bench camera: whether the
bench sphere's pair load (bench.py: 2.5897M pairs, 4.68 a pixel) looks
like a trained model's. It is also the port's training path at full
width, so it reports the step wall by 200-iteration window as the model
grows (host wall, and device busy ms of profiled steps), the growth
events and the peak device memory (trainsmoke_chip_torch.train_recorded).

    python3 tools/calibrate_scene_torch.py [iterations]     # default 4000

Differences from the JAX tool: the port renders in exact carry (the JAX
tool's ground truth and training run its default bf16 carry), and the
PSNR is of ring view 0 rendered through its own camera (the JAX tool
compares its bench-camera render with ring view 0's image).

Imports torch, numpy and gs2mesh_torch only. ``main`` runs on "cuda" unless
the caller passes device="cpu", and raises where CUDA is missing.
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..")))

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.camera import make_camera
from gs2mesh_torch.core.sh import rgb_to_sh_dc
from gs2mesh_torch.models.gaussians import GaussianModel, activations
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
from gs2mesh_torch.train.trainer import TrainConfig, Trainer, render_model

import trainsmoke_chip_torch as smoke

W, H = 960, 576
N_GAUSS = 300_000
N_RING = 24
FOV = math.radians(60)
N_INIT = 30_000


def bench_scene(n_gauss):
    """The bench sphere: __graft_entry__._scene's numpy draws (seed 0, SH
    degree 0), as a dict of float32 arrays in rasterize's argument order.
    Its float32 casts fall where _scene's do, so its bits differ from
    trainsmoke_chip_torch.sphere_scene's draws of the same seed."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_gauss, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    means = (v * 1.0).astype(np.float32)
    scales = (np.abs(rng.normal(0.04, 0.012, size=(n_gauss, 3)))
              + 1e-3).astype(np.float32)
    quat = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, size=(n_gauss,)).astype(np.float32)
    shs = np.zeros((n_gauss, 1, 3), np.float32)
    shs[:, 0, :] = rgb_to_sh_dc(
        rng.uniform(0.05, 0.95, size=(n_gauss, 3)).astype(np.float32))
    return dict(means3d=means, scales=scales, rotations=quat,
                opacities=opac, shs=shs)


def bench_pose():
    """(R, T) of the bench camera: in front of the sphere at distance 3."""
    return smoke.look_at_pose(np.array([0.0, 0.0, -3.0]))


def ring_poses(n=N_RING):
    """(R, T) of the ring views: distance 3, the elevation cycling through
    -0.25, 0, 0.25."""
    poses = []
    for i in range(n):
        ang, elev = 2 * np.pi * i / n, 0.25 * ((i % 3) - 1)
        poses.append(smoke.look_at_pose(
            3.0 * np.array([np.sin(ang), elev, -np.cos(ang)])))
    return poses


def camera(pose, width=W, height=H, device="cuda"):
    R, T = pose
    return make_camera(R, T, FOV, FOV, width, height, device=device)


def shell_init():
    """(points, colours): N_INIT points on the 0.95-1.05 shell, colours in
    [0.2, 0.8], drawn by default_rng(0)."""
    n = N_INIT
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * rng.uniform(0.95, 1.05, (n, 1))
    return pts.astype(np.float32), rng.uniform(0.2, 0.8, (n, 3))


def run(iterations=4000, device="cuda"):
    """The calibration: (the trained Trainer, main's dict)."""
    device = resolve_device(device)
    rcfg = RasterizerConfig(pair_capacity=1 << 22)
    t0 = time.perf_counter()
    gt = bench_scene(N_GAUSS)
    gt_args = [torch.as_tensor(gt[k], device=device) for k in smoke.KEYS]
    cams = [camera(p, device=device) for p in ring_poses()]
    images = []
    with torch.no_grad():
        for c in cams:
            out = rasterize(*gt_args, c, 0, cfg=rcfg)
            smoke.check(not bool(out.overflow), "ground-truth render overflow")
            images.append(torch.clamp(out.image, 0, 1).cpu().numpy())
    del gt_args
    gt_s = time.perf_counter() - t0
    print(f"GT views rendered ({gt_s:.2f} s)", flush=True)

    pts, cols = shell_init()
    model = GaussianModel.from_point_cloud(
        pts, cols, max_sh_degree=0, capacity=1 << 19, spatial_lr_scale=3.0,
        device=device)
    cfg = TrainConfig(iterations=iterations, sh_degree=0,
                      densify_from_iter=500,
                      densify_until_iter=iterations - 500,
                      densification_interval=100,
                      opacity_reset_interval=3000)
    tr = Trainer(model=model, cameras=cams, images=images, cfg=cfg,
                 rcfg=rcfg, scene_extent=3.0, device=device)
    rec = smoke.train_recorded(tr, iterations, log_every=500)
    losses = rec.pop("losses")
    print(f"trained {iterations} iters in {rec['wall_s']:.1f}s "
          f"({iterations / rec['wall_s']:.2f} it/s)")

    # Emission statistics of the TRAINED model on the bench camera.
    cam0 = camera(bench_pose(), device=device)
    zeros = torch.zeros(3, device=device)
    with torch.no_grad():
        out = render_model(tr.model.params, tr.model.alive, cam0, 0, zeros,
                           tr.rcfg)
        inp = activations(tr.model.params, tr.model.alive)
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam0, 0, tr.rcfg)
    radii = prep.radius.cpu().numpy()
    live = radii[radii > 0]
    pairs = int(out.num_pairs)
    result = {
        "metric": "calibrate_scene",
        "device": smoke.device_name(device),
        "iterations": iterations,
        "gt_render_s": gt_s,
        "it_per_s": iterations / rec["wall_s"],
        "first_loss": losses[0],
        "final_loss_ma50": float(np.mean(losses[-50:])),
        "alive_start": N_INIT,
        "alive_final": tr.num_alive(),
        "params_finite": smoke.params_finite(tr.model),
        "pair_capacity_final": tr.rcfg.pair_capacity,
        "model_capacity_final": tr.capacity,
        "bench_camera_pairs": pairs,
        "bench_camera_overflow": bool(out.overflow),
        "pairs_per_pixel": pairs / (W * H),
        "radius_px": {"p50": float(np.percentile(live, 50)),
                      "p90": float(np.percentile(live, 90)),
                      "p99": float(np.percentile(live, 99)),
                      "mean": float(live.mean())},
        "train_view_psnr_db": tr.report_psnr([0]),
        **rec,
    }
    print(json.dumps(result, indent=1))
    return tr, result


def main(iterations=4000, device="cuda"):
    return run(iterations, device)[1]


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4000)
