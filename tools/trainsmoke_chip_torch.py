"""Sustained-training smoke of the PyTorch port on one CUDA card.

The port's counterpart of tools/trainsmoke_chip.py: the port's host
Trainer (K1 emission, the sort, K2 compositing, K3 / K4 backward, the
densify / prune cadence, the opacity reset, capacity growth and the
pair-overflow redo) for 1,200 iterations on a synthetic multi-view scene,
then the JAX tool's checks: the loss drops materially, densification grew
the model, the parameters stay finite.

    python3 tools/trainsmoke_chip_torch.py [iterations]

Beside the JAX tool's keys the result carries, for each 200-iteration
window, the median step wall on a synchronised host clock and the device
busy ms a step of 10 profiled steps (torch.profiler), the alive rows and
pairs at each densify, how often the model and the pair capacity grew,
K1-K4 launches against the taken steps and the peak device memory.

One deliberate difference: the JAX tool trains through impl="pallas" with
the bf16 feature and gradient carries; the port has only the exact carry
(gs2mesh_torch/ops/rasterizer/config.py), so its run is the JAX run in
exact carry.

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
from gs2mesh_torch.models.gaussians import GaussianModel
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, kernel_wrappers
from gs2mesh_torch.ops.rasterizer.golden import render_golden
from gs2mesh_torch.train.trainer import TrainConfig, Trainer, render_model

W, H = 480, 288
N_VIEWS = 6
KEYS = ("means3d", "scales", "rotations", "opacities", "shs")
WINDOW = 200          # iterations per step-wall window
# Steps of each window (1-based within it) run under torch.profiler for the
# window's device busy time; they stay out of its host-wall median. No
# densify or opacity reset of either tool falls on them.
PROFILED = range(21, 31)
FORCED_ITERS = 120    # iterations of the forced-growth run


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def sphere_scene(n=512, seed=0, sh_degree=0):
    """Random gaussians on the unit sphere with random colours (the draws
    of tests/scenes.py::sphere_scene at its default radius 1 and scale
    0.04); a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    means = (v * 1.0).astype(np.float32)
    scales = np.abs(rng.normal(loc=0.04, scale=0.04 * 0.3,
                               size=(n, 3))).astype(np.float32) + 1e-3
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    K = (sh_degree + 1) ** 2
    shs = np.zeros((n, K, 3), np.float32)
    shs[:, 0, :] = rgb_to_sh_dc(rng.uniform(0.05, 0.95, size=(n, 3)))
    if K > 1:
        shs[:, 1:, :] = rng.normal(scale=0.02, size=(n, K - 1, 3))
    return dict(means3d=means, scales=scales,
                rotations=quat.astype(np.float32), opacities=opac, shs=shs)


def look_at_pose(eye):
    """(R, T) in the GS convention of a camera at ``eye`` looking at the
    origin, y up: the world-to-view rows are (right, down, forward)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    Rw2v = np.stack([right, np.cross(fwd, right), fwd], axis=0)
    return Rw2v.T, -Rw2v @ eye


def orbit_poses(n_views=N_VIEWS):
    """(R, T) of each orbit camera: radius 2.8 around the origin, the
    height bobbing with twice the angle."""
    poses = []
    for i in range(n_views):
        th = 2 * math.pi * i / n_views
        poses.append(look_at_pose(np.array([
            2.8 * math.cos(th), 0.4 * math.sin(2 * th), 2.8 * math.sin(th)])))
    return poses


def orbit_cameras(n_views=N_VIEWS, width=W, height=H, device="cuda"):
    """The orbit cameras at 55 x 40 degrees of field of view."""
    return [make_camera(R, T, math.radians(55), math.radians(40), width,
                        height, device=device)
            for R, T in orbit_poses(n_views)]


def golden_targets(scene, cameras):
    """(3, H, W) numpy targets of a sphere_scene dict, rendered by
    render_golden (per-pixel compositing, no pair buffer) on the cameras'
    device."""
    dev = cameras[0].device
    args = [torch.as_tensor(scene[k], device=dev) for k in KEYS]
    with torch.no_grad():
        return [render_golden(*args, cam, 0)[0].cpu().numpy()
                for cam in cameras]


def sparse_init(scene, n_init, capacity, device, seed=0):
    """A model from n_init of the scene's centres, drawn by
    default_rng(seed), with uniform(0.2, 0.8) colours and SH degree 0."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(scene["means3d"]), n_init, replace=False)
    return GaussianModel.from_point_cloud(
        scene["means3d"][sel],
        rng.uniform(0.2, 0.8, (n_init, 3)).astype(np.float32),
        max_sh_degree=0, capacity=capacity, device=device)


def params_finite(model) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in model.params.tensors())


def prune_candidates(tr: Trainer) -> dict:
    """Alive rows over each threshold of the size and opacity prunes:
    opacity under 0.005 and (applied only after the first opacity reset) a
    world scale over a tenth of the scene extent, which Trainer.densify
    prunes; and screen_over_20px, the rows whose largest screen radius
    since the last densify is over 20 px, which the JAX package's densify
    prunes after the first reset and the port's (as the reference's) does
    not. (Until the port zeroed every row's radii at each densify, the
    radius was the largest since the row was born, as JAX keeps it.)"""
    st, p = tr.model.state, tr.model.params
    return dict(
        opacity_under_0_005=int((st.alive & (torch.sigmoid(
            p.opacity[:, 0]) < 0.005)).sum()),
        screen_over_20px=int((st.alive & (st.max_radii2D > 20.0)).sum()),
        world_over_tenth_extent=int((st.alive & (torch.exp(
            p.scaling).amax(1) > 0.1 * tr.scene_extent)).sum()))


def device_activity(prof):
    """(device ms, device events) of the kernels, copies and fills a
    torch.profiler profile recorded; a range on the device track repeats
    the time of the kernels under it and is left out. Reads the profiler's
    raw results: building its event tree (prof.events()) takes seconds."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA
          and not e.is_user_annotation()]
    return sum(e.duration_ns() for e in ev) / 1e6, len(ev)


def train_recorded(tr: Trainer, iterations: int, log_every: int = 0,
                   window: int = WINDOW, callback=None) -> dict:
    """tr.train(iterations) with a record of every taken step: the losses,
    the step walls (host clock, synchronised after each step, so a step's
    wall includes its densify or redo), each densify's alive rows, pairs,
    step wall and the prune candidates of the step before it, every growth
    of the model and of the pair capacity (growths: iteration, what, old,
    new), K1-K4 launches and the peak device memory (also by window). On the
    card the steps PROFILED of each ``window``-step window run under
    torch.profiler (device activity only): the window's device busy ms and
    device events a step, and its idle share against the median wall of
    its other steps. ``callback(tr, out)`` runs after each taken step's
    record. wall_s is the whole run's host wall less profile_s, the time
    spent starting the profiles and reading them, and less callback_s."""
    from torch.profiler import ProfilerActivity, profile

    cfg = tr.cfg

    def densifies_at(it):
        return (cfg.densify_from_iter <= it <= cfg.densify_until_iter
                and it % cfg.densification_interval == 0)
    cuda = tr.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = kernel_wrappers()
    cap0, pcap0 = tr.capacity, tr.rcfg.pair_capacity
    losses, walls, pairs, alive, densifies = [], [], [], [], []
    over_capacity, growths, peaks = [], [], []
    prof, busy = [None], {}      # the open profile; window -> (ms, events)
    profile_s = [0.0]            # spent starting and reading the profiles
    callback_s = [0.0]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    it0 = tr.iteration
    last = [t0, tr.num_alive(), prune_candidates(tr),
            dict(capacity=tr.capacity, pair_capacity=tr.rcfg.pair_capacity)]

    def record(t, out):
        sync()
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        n = t.num_alive()
        losses.append(float(out.loss))
        pairs.append(int(out.num_pairs))
        alive.append(n)
        if pairs[-1] > t.rcfg.pair_capacity:
            over_capacity.append(t.iteration)
        it = t.iteration
        for what, new in (("capacity", t.capacity),
                          ("pair_capacity", t.rcfg.pair_capacity)):
            if new != last[3][what]:
                growths.append(dict(iteration=it, what=what,
                                    old=last[3][what], new=new))
                last[3][what] = new
        if densifies_at(it):
            densifies.append(dict(iteration=it, alive_before=last[1],
                                  alive_after=n, pairs=pairs[-1],
                                  capacity=t.capacity, wall_ms=walls[-1],
                                  candidates_before=last[2]))
        if densifies_at(it + 1):
            last[2] = prune_candidates(t)
        w, offset = divmod(len(walls) - 1, window)
        tp = time.perf_counter()
        if cuda and offset + 2 == PROFILED[0]:
            prof[0] = profile(activities=[ProfilerActivity.CUDA])
            prof[0].__enter__()
        elif prof[0] is not None and offset + 1 == PROFILED[-1]:
            prof[0].__exit__(None, None, None)
            busy[w] = device_activity(prof[0])
            prof[0] = None
        if offset + 1 == window and cuda:
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
        tc = time.perf_counter()
        profile_s[0] += tc - tp
        if callback is not None:
            callback(t, out)
        last[0], last[1] = time.perf_counter(), n
        callback_s[0] += last[0] - tc

    tr.train(iterations, log_every=log_every, callback=record)
    wall = time.perf_counter() - t0 - profile_s[0] - callback_s[0]
    if prof[0] is not None:       # a last window shorter than PROFILED
        prof[0].__exit__(None, None, None)
    if cuda and len(walls) % window:
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    windows = []
    for w, a in enumerate(range(0, len(walls), window)):
        b = min(a + window, len(walls))
        plain = [ms for i, ms in enumerate(walls[a:b], 1)
                 if not cuda or i not in PROFILED]
        rec = dict(iterations=[it0 + a + 1, it0 + b],
                   median_ms=float(np.median(plain)),
                   alive_end=alive[b - 1],
                   median_pairs=float(np.median(pairs[a:b])),
                   device_busy_ms=None, device_events=None, idle_share=None,
                   peak_memory_gib=peaks[w] if cuda else None)
        if busy.get(w, (0, 0))[0] > 0:     # else: not measured
            ms, events = busy[w]
            rec.update(device_busy_ms=ms / len(PROFILED),
                       device_events=events / len(PROFILED),
                       idle_share=1 - ms / len(PROFILED) / rec["median_ms"])
        windows.append(rec)
    return dict(
        losses=losses, wall_s=wall, profile_s=profile_s[0],
        callback_s=callback_s[0], taken_steps=len(losses),
        step_ms_windows=windows, densifies=densifies,
        capacity_grows=int(round(math.log2(tr.capacity / cap0))),
        pair_capacity_grows=int(round(math.log2(
            tr.rcfg.pair_capacity / pcap0))),
        growths=growths, over_capacity_steps=over_capacity,
        launches={k: c.launches - start[k] for k, c in counters.items()},
        peak_memory_gib=max(peaks) if cuda else None)


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def forced_growth(scene, cameras, images, n_init=500):
    """FORCED_ITERS iterations that take both growth paths on purpose: a
    2 x n_init row capacity, densify
    every 20 iterations from 20 to 100 with a 1e-9 gradient threshold (so
    nearly every row is cloned or split), and a pair capacity of half the
    first render's pairs (the first step overflows, grows it and is
    redone). Returns train_recorded's dict with the trainer."""
    dev = cameras[0].device
    model = sparse_init(scene, n_init, capacity=2 * n_init, device=dev)
    with torch.no_grad():
        first = render_model(model.params, model.alive, cameras[0], 0,
                             torch.zeros(3, device=dev),
                             RasterizerConfig(pair_capacity=1 << 20))
    pair_capacity = max(int(first.num_pairs) // 2, 1)
    cfg = TrainConfig(sh_degree=0, densify_from_iter=20,
                      densification_interval=20, densify_until_iter=100,
                      opacity_reset_interval=10_000,
                      densify_grad_threshold=1e-9, iterations=FORCED_ITERS)
    tr = Trainer(model=model, cameras=cameras, images=images, cfg=cfg,
                 rcfg=RasterizerConfig(pair_capacity=pair_capacity),
                 scene_extent=3.0, seed=0, device=dev)
    rec = train_recorded(tr, FORCED_ITERS)
    rec.update(first_pairs=int(first.num_pairs),
               pair_capacity_start=pair_capacity,
               pair_capacity_final=tr.rcfg.pair_capacity,
               model_capacity_start=2 * n_init,
               model_capacity_final=tr.capacity,
               alive_final=tr.num_alive(), params_finite=params_finite(
                   tr.model))
    return tr, rec


def run(iterations=1200, device="cuda"):
    """The smoke with its checks: (the trained Trainer, main's dict)."""
    device = resolve_device(device)
    if device.type == "cuda":
        from gs2mesh_torch import _build

        _build.library("emit")          # every csrc/*.cu, before the clock
    t0 = time.perf_counter()
    scene = sphere_scene(n=4000, seed=2)
    cams = orbit_cameras(N_VIEWS, W, H, device)
    images = golden_targets(scene, cams)
    # Sparse init (1/8 of the ground-truth points) so densification has
    # real work to do.
    model = sparse_init(scene, 500, capacity=4096, device=device)
    # The JAX tool's cadences: reset at 1000, densify from 200 to 700 every
    # 150; a scene extent near the orbit radius (with 1.0 the post-reset
    # world-size prune culls the whole model).
    cfg = TrainConfig(sh_degree=0, densify_from_iter=200,
                      densification_interval=150, densify_until_iter=700,
                      opacity_reset_interval=1000, iterations=iterations)
    tr = Trainer(model=model, cameras=cams, images=images, cfg=cfg,
                 rcfg=RasterizerConfig(pair_capacity=1 << 18),
                 scene_extent=3.0, seed=0, device=device)
    setup_s = time.perf_counter() - t0
    rec = train_recorded(tr, iterations, log_every=300)
    losses = rec.pop("losses")
    first, final = losses[0], float(np.mean(losses[-50:]))
    alive = tr.num_alive()
    finite = params_finite(tr.model)
    result = {
        "metric": "train_smoke_chip",
        "device": device_name(device),
        "iterations": iterations,
        "setup_s": setup_s,
        "ms_per_iter": rec["wall_s"] / iterations * 1e3,
        "first_loss": first,
        "final_loss_ma50": final,
        "alive_start": 500,
        "alive_final": alive,
        "params_finite": finite,
        "pair_capacity_final": tr.rcfg.pair_capacity,
        "model_capacity_final": tr.capacity,
        **rec,
    }
    print(json.dumps(result, indent=1))
    check(finite, "non-finite parameters after training")
    check(final < 0.5 * first, f"loss {first} -> {final}")
    check(alive > 500, "densification never grew the model")
    print("TRAINSMOKE OK")
    return tr, result


def main(iterations=1200, device="cuda"):
    return run(iterations, device)[1]


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1200)
