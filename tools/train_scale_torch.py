"""The reference's full GS training schedule on a dense synthetic scene, for
the PyTorch port on one CUDA card.

The ground truth is 1,000,000 flat SH-0 splats on a textured unit sphere
and a textured ground plane under it (tangent to their surface, opacity
0.7-0.99, each 1-4 px across per axis at 960x576 from the ring distance).
The texture is a grid of cells TEXTURE_SCALE wide in the world, each with
its own random colour, and every splat adds its own independent random
jitter to its cell's colour. TEXTURE_SCALE is the scene's one free choice:
``probe`` calibrates it, so that a fit of the scene grows to 100k-1M rows
by the end of densification.

``write_scene`` renders 64 training views (three rings looking at the
sphere, 960x576, 60 degrees of horizontal field of view) and 8 held-out
views between the rings through the port's ``rasterize`` and writes them
as the GS stage's input: images/NNN.png, a binary COLMAP model in
sparse/0 (the training views only, and 50,000 ground-truth centres with a
jitter of 1% of the scene extent and their colours as its points), and
heldout/NNN.png. ``run`` then builds the GS stage's own trainer
(``pipeline.run_single.gs_trainer``: load_colmap_scene ->
GaussianModel.from_point_cloud -> Trainer, pair capacity 1 << 22) and
trains TrainConfig()'s schedule (30,000 iterations, densify every 100 from
500 to 15,000, opacity resets every 3,000, SH warm-up to degree 3),
recorded by ``trainsmoke_chip_torch.train_recorded`` in 1,000-iteration
windows, saving checkpoints where the GS stage does (7,000 and the end).
It reports the held-out PSNR at each checkpoint, the alive rows at
15,000, the trained model's pairs a pixel and render ms through
``pipeline.renderer_stage.Renderer`` on a training camera and on the bench
camera, and (on the card) one step's K1-K4 against their plain versions on
the states at 15,000 and at the end (``chip_smoke.trained_step_vs_plain``).

    python3 tools/train_scale_torch.py [iterations] [--seed N]   # 30000, 0

Imports torch, numpy and gs2mesh_torch only (and, on the card, the repo's
chip_smoke.py). ``main`` runs on "cuda" unless the caller passes
device="cpu", and raises where CUDA is missing.
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
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.camera import make_camera
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.core.sh import rgb_to_sh_dc
from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.ops.ssim import psnr
from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.run_single import gs_trainer
from gs2mesh_torch.train.scene import get_nerfpp_norm
from gs2mesh_torch.train.trainer import render_model

import trainsmoke_chip_torch as smoke

W, H = 960, 576
N_GAUSS = 1_000_000
N_SPARSE = 50_000
# (elevation in degrees, views) of the training rings and of the held-out
# views between them, all at DISTANCE from the origin looking at it.
RINGS = ((15.0, 21), (30.0, 21), (45.0, 22))
HELD_OUT = ((22.5, 4), (37.5, 4))
DISTANCE = 3.0
PLANE_Y, PLANE_HALF = -1.05, 2.5     # the ground: y = PLANE_Y, |x|, |z| <= 2.5
SPLAT_PX = (1.0, 4.0)                # per-axis size at DISTANCE, in pixels
FLAT = 1e-5                          # the splats' scale along their normal
JITTER = 0.2                         # per-splat colour jitter, +-0.1
# The texture's cell width (world units): probe([0.01, 0.04, 0.16, 0.32])
# on the card extrapolated 2.44M, 1.74M, 652k and 451k alive rows at 15,000
# (PERF.md, section 6).
TEXTURE_SCALE = 0.32
GT_PAIR_CAPACITY = 4 << 22
WINDOW = 1000
CHECK_AT = 15_000                    # densification's last iteration
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "train_scale_out")


def focal(width):
    """The focal length in pixels of 60 degrees across ``width``."""
    return width / (2 * math.tan(math.radians(30)))


def tangent_quats(normal, theta):
    """(n, 4) unit quaternions (w, x, y, z) of rotations that turn the z
    axis by ``theta`` about itself and then onto ``normal``: a splat's
    first two axes lie in the surface, at a random angle."""
    axis = np.cross([0.0, 0.0, 1.0], normal)
    s = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = np.where(s > 1e-9, axis / np.maximum(s, 1e-12), [[1.0, 0, 0]])
    half = 0.5 * np.arccos(np.clip(normal[:, 2:], -1.0, 1.0))
    aw, av = np.cos(half), np.sin(half) * axis
    bw, bz = np.cos(0.5 * theta), np.sin(0.5 * theta)
    bv = np.concatenate([np.zeros_like(bz), np.zeros_like(bz), bz], axis=1)
    return np.concatenate([aw * bw - (av * bv).sum(1, keepdims=True),
                           aw * bv + bw * av + np.cross(av, bv)], axis=1)


def ground_truth(n=N_GAUSS, seed=0, texture_scale=TEXTURE_SCALE):
    """The scene's splats from default_rng(seed): a dict of float32 arrays
    in rasterize's argument order (SH degree 0), and "rgb", their colours.
    The sphere and the plane hold n splats between them in proportion to
    their areas; splat sizes are fixed in the world (1-4 px at DISTANCE
    through a 960-wide 60-degree camera), whatever the render size."""
    rng = np.random.default_rng(seed)
    area_s, area_p = 4 * math.pi, (2 * PLANE_HALF) ** 2
    n_s = round(n * area_s / (area_s + area_p))
    v = rng.normal(size=(n_s, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xz = rng.uniform(-PLANE_HALF, PLANE_HALF, size=(n - n_s, 2))
    plane = np.stack([xz[:, 0], np.full(n - n_s, PLANE_Y), xz[:, 1]], axis=1)
    means = np.concatenate([v, plane])
    normal = np.concatenate([v, np.tile([0.0, 1.0, 0.0], (n - n_s, 1))])
    quat = tangent_quats(normal, rng.uniform(0, 2 * math.pi, size=(n, 1)))
    px = np.exp(rng.uniform(*np.log(SPLAT_PX), size=(n, 2)))
    scales = np.concatenate([px * DISTANCE / focal(W),
                             np.full((n, 1), FLAT)], axis=1)
    opac = rng.uniform(0.7, 0.99, size=n)
    cells = np.floor(means / texture_scale).astype(np.int64)
    _, cell = np.unique(cells, axis=0, return_inverse=True)
    base = rng.uniform(0.05, 0.95, size=(int(cell.max()) + 1, 3))
    rgb = np.clip(base[cell.reshape(-1)]
                  + JITTER * (rng.uniform(size=(n, 3)) - 0.5), 0.0, 1.0)
    out = dict(means3d=means, scales=scales, rotations=quat, opacities=opac,
               shs=rgb_to_sh_dc(rgb)[:, None, :], rgb=rgb)
    return {k: x.astype(np.float32) for k, x in out.items()}


def look_at_pose(eye):
    """(R, T) in the GS convention of a camera at ``eye`` looking at the
    origin with world +y up: the world-to-view rows are (right, down,
    forward)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    Rw2v = np.stack([right, np.cross(fwd, right), fwd], axis=0)
    return Rw2v.T, -Rw2v @ eye


def ring_eyes(rings, stagger):
    """Camera centres of ``rings`` ((elevation degrees, count), ...); ring
    k's azimuths start (k + stagger) / 2 of its step along."""
    eyes = []
    for k, (elev, n) in enumerate(rings):
        e = math.radians(elev)
        for i in range(n):
            az = 2 * math.pi * (i + 0.5 * (k + stagger)) / n
            eyes.append(DISTANCE * np.array([
                math.cos(e) * math.sin(az), math.sin(e),
                -math.cos(e) * math.cos(az)]))
    return eyes


def train_eyes():
    return ring_eyes(RINGS, 0.0)


def heldout_eyes():
    return ring_eyes(HELD_OUT, 0.5)


def camera(eye, width=W, height=H, device="cuda"):
    """The camera at ``eye``: 60 degrees across the width, square pixels."""
    R, T = look_at_pose(eye)
    return make_camera(R, T, math.radians(60),
                       2 * math.atan(height / (2 * focal(width))), width,
                       height, device=device)


def to_uint8(image):
    """(3, H, W) float image -> (H, W, 3) uint8, rounded."""
    img = torch.clamp(image, 0, 1).permute(1, 2, 0).cpu().numpy()
    return np.round(img * 255.0).astype(np.uint8)


def write_scene(root, n_gauss=N_GAUSS, width=W, height=H, seed=0,
                texture_scale=TEXTURE_SCALE, pair_capacity=GT_PAIR_CAPACITY,
                device="cuda"):
    """The scene in the GS stage's input layout under ``root`` (images/,
    sparse/0 binary, heldout/), its views rendered at ``pair_capacity``;
    returns the ground-truth renders' pairs, the seconds it took, the
    scene extent and the number of COLMAP points."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    gt = ground_truth(n_gauss, seed, texture_scale)
    args = [torch.as_tensor(gt[k], device=device) for k in smoke.KEYS]
    rcfg = RasterizerConfig(pair_capacity=pair_capacity)
    pairs = {}
    for folder, eyes in (("images", train_eyes()),
                         ("heldout", heldout_eyes())):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        pairs[folder] = []
        for i, eye in enumerate(eyes):
            with torch.no_grad():
                out = rasterize(*args, camera(eye, width, height, device), 0,
                                cfg=rcfg)
            smoke.check(not bool(out.overflow) and not bool(
                out.tile_overflow), f"{folder} {i}: ground truth overflow")
            pairs[folder].append(int(out.num_pairs))
            write_png(os.path.join(root, folder, f"{i:03}.png"),
                      to_uint8(out.image))
    del args

    f = focal(width)
    cams = {1: colmap_io.ColmapCamera(
        id=1, model="PINHOLE", width=width, height=height,
        params=np.array([f, f, width / 2, height / 2]))}
    images = {}
    for i, eye in enumerate(train_eyes()):
        R, T = look_at_pose(eye)
        images[i + 1] = colmap_io.ColmapImage(
            id=i + 1, qvec=rotmat2qvec_wxyz(R.T), tvec=T, camera_id=1,
            name=f"{i:03}.png", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64))
    # COLMAP's stand-in: ground-truth centres jittered by 1% of the extent
    # (the training cameras' nerf-norm radius, the trainer's scene extent).
    rng = np.random.default_rng(seed + 1)
    extent = get_nerfpp_norm(np.stack(train_eyes()))[1]
    sel = rng.choice(n_gauss, min(N_SPARSE, n_gauss), replace=False)
    xyz = gt["means3d"][sel] + rng.normal(scale=0.01 * extent,
                                          size=(len(sel), 3))
    rgb = np.round(gt["rgb"][sel] * 255).astype(np.uint8)
    empty = np.zeros((0,), np.int64)
    points = {i + 1: colmap_io.ColmapPoint3D(i + 1, p, c, 0.0, empty, empty)
              for i, (p, c) in enumerate(zip(xyz, rgb))}
    colmap_io.write_model_binary(os.path.join(root, "sparse", "0"), cams,
                                 images, points)
    return dict(gt_pairs=pairs, scene_s=time.perf_counter() - t0,
                scene_extent=extent, n_points=len(points))


def heldout_psnr(tr, root):
    """Mean PSNR (dB) of the held-out views rendered from the trainer's
    model at its active SH degree against their PNGs."""
    width, height = tr.cameras[0].width, tr.cameras[0].height
    rcfg = RasterizerConfig(pair_capacity=2 * tr.rcfg.pair_capacity)
    vals = []
    for i, eye in enumerate(heldout_eyes()):
        target = torch.tensor(read_png(os.path.join(
            root, "heldout", f"{i:03}.png")).transpose(2, 0, 1) / 255.0,
            dtype=torch.float32, device=tr.device)
        with torch.no_grad():
            out = render_model(tr.model.params, tr.model.alive,
                               camera(eye, width, height, tr.device),
                               tr.model.active_sh_degree, tr._bg(), rcfg)
        smoke.check(not bool(out.overflow), f"held-out view {i} overflow")
        vals.append(float(psnr(out.image, target)))
    return float(np.mean(vals))


def render_probe(root, ply, width, height, pair_capacity, device, reps=10):
    """Through pipeline.renderer_stage.Renderer, from a text COLMAP model
    of two views (training view 0 and the bench camera: distance 3 in
    front, 60 x 60 degrees of field of view as bench.py has it): each
    view's pairs, pairs a pixel and median render_single ms of ``reps``
    after a warm-up (synchronised host clock)."""
    from gs2mesh_torch.pipeline.renderer_stage import Renderer

    f = focal(width)
    fy_bench = height / (2 * math.tan(math.radians(30)))
    cams, images = {}, {}
    bench = smoke.look_at_pose(np.array([0.0, 0.0, -3.0]))
    for i, (name, (R, T), fy) in enumerate((
            ("train_view_0", look_at_pose(train_eyes()[0]), f),
            ("bench_camera", bench, fy_bench)), 1):
        cams[i] = colmap_io.ColmapCamera(
            id=i, model="PINHOLE", width=width, height=height,
            params=np.array([f, fy, width / 2, height / 2]))
        images[i] = colmap_io.ColmapImage(
            id=i, qvec=rotmat2qvec_wxyz(R.T), tvec=T, camera_id=i,
            name=f"{name}.png", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64))
    probe = os.path.join(root, "render_probe")
    colmap_io.write_model_text(os.path.join(probe, "sparse", "0"), cams,
                               images, {})
    r = Renderer(root, probe, os.path.join(probe, "renders"),
                 PipelineArgs.for_dataset("custom", colmap_name="probe",
                                          renderer_sort_cameras=False),
                 ply_path=ply, device=device)
    r.prepare_renderer(pair_capacity)
    sync = (torch.cuda.synchronize if r.device.type == "cuda"
            else (lambda: None))
    out = {}
    for name, cam in zip(("train_view_0", "bench_camera"), r.left_cameras):
        r.render_single(cam)                       # warm-up
        ms = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            r.render_single(cam)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        n = int(r.last_output.num_pairs)
        out[name] = dict(pairs=n, pairs_per_pixel=n / (width * height),
                         render_ms_median=float(np.median(ms)))
    return out


def alive_checks(densifies, reset_every):
    """Each opacity reset's densify (its iteration is a multiple of
    ``reset_every``; the reset follows it) and the lowest alive count at
    the densifies after it, before the next reset: (iteration, alive at
    the reset's densify, lowest after)."""
    out = []
    for d in densifies:
        if d["iteration"] % reset_every == 0:
            after = [e["alive_after"] for e in densifies
                     if d["iteration"] < e["iteration"]
                     < d["iteration"] + reset_every]
            if after:
                out.append((d["iteration"], d["alive_after"], min(after)))
    return out


def run(iterations=30_000, device="cuda", root=OUT, n_gauss=N_GAUSS,
        width=W, height=H, seed=0, texture_scale=TEXTURE_SCALE,
        pair_capacity=1 << 22):
    """The scene under ``root`` (its views rendered at 4 x
    ``pair_capacity``), the GS stage's trainer on it for ``iterations``
    (TrainConfig's schedule, ``pair_capacity`` the GS stage's), its record
    and its checks (the loss's, over two windows or more): (the trained
    Trainer, main's dict)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        from gs2mesh_torch import _build

        _build.library("emit")          # every csrc/*.cu, before the clock
    scene = write_scene(root, n_gauss, width, height, seed, texture_scale,
                        4 * pair_capacity, device)
    print(f"scene written ({scene['scene_s']:.2f} s; ground-truth pairs a "
          f"training view {min(scene['gt_pairs']['images'])}-"
          f"{max(scene['gt_pairs']['images'])})", flush=True)
    t0 = time.perf_counter()
    tr = gs_trainer(root, iterations, white_background=False,
                    pair_capacity=pair_capacity, device=device)
    setup_s = time.perf_counter() - t0
    model_dir = os.path.join(root, "model")
    save_at = {i for i in PipelineArgs().GS_save_test_iterations
               if i <= iterations} | {iterations}
    psnr_at, alive_at, vs_plain = {}, {}, {}

    def at_iteration(t, out):
        it = t.iteration
        if it in save_at:
            t.save_checkpoint(model_dir)
            psnr_at[it] = heldout_psnr(t, root)
        if it in (CHECK_AT, iterations):
            alive_at[it] = t.num_alive()
            if cuda:
                import chip_smoke

                vs_plain[it] = chip_smoke.trained_step_vs_plain(
                    t, f"trained step at {it}")

    rec = smoke.train_recorded(tr, iterations, log_every=WINDOW,
                               window=WINDOW, callback=at_iteration)
    losses = rec.pop("losses")
    n = min(WINDOW, len(losses))
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{iterations}",
                       "point_cloud.ply")
    renders = render_probe(root, ply, width, height,
                           2 * tr.rcfg.pair_capacity, device)
    reset = tr.cfg.opacity_reset_interval
    result = {
        "metric": "train_scale",
        "device": smoke.device_name(device),
        "iterations": iterations,
        "n_gauss": n_gauss, "size": [width, height],
        "texture_scale": texture_scale, "seed": seed,
        "scene_s": scene["scene_s"], "setup_s": setup_s,
        "gt_pairs": scene["gt_pairs"],
        "scene_extent": scene["scene_extent"],
        "alive_start": scene["n_points"],
        "ms_per_iter": rec["wall_s"] / iterations * 1e3,
        "first_loss_mean": float(np.mean(losses[:n])),
        "last_loss_mean": float(np.mean(losses[-n:])),
        "alive_final": tr.num_alive(),
        "alive_at": alive_at,
        "params_finite": smoke.params_finite(tr.model),
        "pair_capacity_final": tr.rcfg.pair_capacity,
        "model_capacity_final": tr.capacity,
        "heldout_psnr_db": psnr_at,
        "renders": renders,
        "reset_alive": alive_checks(rec["densifies"], reset),
        "trained_vs_plain_max_abs_err": vs_plain if cuda else None,
        **rec,
    }
    print(json.dumps(result, indent=1))
    smoke.check(result["params_finite"], "non-finite parameters")
    if len(losses) >= 2 * WINDOW:
        smoke.check(
            result["last_loss_mean"] < 0.5 * result["first_loss_mean"],
            f"loss {result['first_loss_mean']} -> {result['last_loss_mean']}")
    for it, before, low in result["reset_alive"]:
        smoke.check(low >= 0.5 * before, f"alive {before} at the densify of "
                    f"the reset at {it}, {low} after it")
    if CHECK_AT in alive_at and (n_gauss, width, height) == (N_GAUSS, W, H):
        smoke.check(100_000 <= alive_at[CHECK_AT] <= 1_000_000,
                    f"{alive_at[CHECK_AT]} alive rows at {CHECK_AT}, not "
                    f"100k-1M: calibrate TEXTURE_SCALE again (probe)")
    print("TRAIN SCALE OK")
    return tr, result


def probe(texture_scales, iterations=3000, device="cuda"):
    """The texture-scale calibration: ``run(iterations)`` at each scale,
    and the alive rows at CHECK_AT extrapolated linearly from the last
    window's growth. Returns {scale: (alive at the end, extrapolated)}."""
    out = {}
    for s in texture_scales:
        _, res = run(iterations, device, texture_scale=s)
        a, b = (w["alive_end"] for w in res["step_ms_windows"][-2:])
        out[s] = (b, b + (b - a) * (CHECK_AT - iterations) / WINDOW)
        print(f"probe texture_scale {s}: alive {b} at {iterations}, "
              f"extrapolated {out[s][1]:.0f} at {CHECK_AT}", flush=True)
    print(json.dumps({"probe": {str(k): v for k, v in out.items()}}))
    return out


def main(iterations=30_000, device="cuda", seed=0):
    return run(iterations, device, seed=seed)[1]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iterations", nargs="?", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=0,
                    help="the ground truth's numpy seed")
    opts = ap.parse_args()
    main(opts.iterations, seed=opts.seed)
