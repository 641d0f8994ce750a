#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gs2mesh_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. needs torch.cuda; prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from gs2mesh_torch/csrc with nvcc (timed);
  3. kernel vs plain on the card, on a seeded 20k-gaussian SH-3 scene at
     256x256: K1 (emission) keys / ids bit for bit after the stable sort,
     K2 (compositing) image and final_T within 2e-5 on >= 99.99% of values
     and every larger difference <= 4e-3 (one 1/255 knife-edge or T-stop
     flip);
  4. the main path at full width: a seeded 300k-gaussian SH-3 model written
     as a GS PLY, a 4-view COLMAP text model at 960x576, and the port's
     Renderer on cuda rendering the 4 stereo pairs to PNG; K1 and K2 must
     each launch once per render, with no pair overflow;
  5. K1 and K2 timed beside their plain versions at the main path's shapes,
     printed as one JSON "kernels" line;
  6. last line: {"ok": true, "device": {...}}.
Scratch files go to smoke_out/ beside this script and are removed at the end.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
# FP32 operations per (pair, pixel) evaluation in K2: 2 for dx/dy, 7 for the
# conic power, 4 for expf (range reduction + polynomial), 1 for the opacity
# product and 6 for the compositing update of an accepted pair.
K2_OPS_PER_EVAL = 20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters):
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sphere_scene(n, seed, sh_degree=3):
    """The bench sphere (__graft_entry__._scene) with small nonzero
    higher-order SH; numpy arrays in GaussianParams layout."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scales = np.abs(rng.normal(0.04, 0.012, size=(n, 3))) + 1e-3
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, size=(n,))
    dc = (rng.uniform(0.05, 0.95, size=(n, 1, 3)) - 0.5) / 0.28209479177387814
    rest = rng.normal(scale=0.02, size=(n, (sh_degree + 1) ** 2 - 1, 3))
    return {k: np.asarray(x, np.float32) for k, x in dict(
        xyz=v, features_dc=dc, features_rest=rest, scaling=np.log(scales),
        rotation=quat, opacity=np.log(opac / (1 - opac))[:, None]).items()}


def look_at(eye):
    """World-to-camera rows (right, down, forward) looking at the origin."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=0)
    return R, -R @ eye


def compare_composite(color_k, T_k, color_p, T_p, what):
    d = torch.cat([(color_k - color_p).abs().flatten(),
                   (T_k - T_p).abs().flatten()])
    n_big = int((d > 2e-5).sum())
    frac_ok = 1.0 - n_big / d.numel()
    max_err = float(d.max())
    log(f"{what}: K2 vs plain: {d.numel()} values, {n_big} above 2e-5 "
        f"({100 * frac_ok:.5f}% within), max abs err {max_err:.3e}")
    check(frac_ok >= 0.9999, f"{what}: K2 agrees on {frac_ok:.6f} < 0.9999")
    check(max_err <= 4e-3, f"{what}: K2 max abs err {max_err} > 4e-3")
    return max_err


def compare_emission(em_k, em_p, num_tiles, what):
    from gs2mesh_torch.ops.rasterizer.emit import sort_pairs

    check(int(em_k.num_pairs) == int(em_p.num_pairs), f"{what}: num_pairs")
    check(torch.equal(em_k.keys, em_p.keys), f"{what}: K1 keys")
    check(torch.equal(em_k.ids, em_p.ids), f"{what}: K1 ids")
    sk, sp = sort_pairs(em_k, num_tiles), sort_pairs(em_p, num_tiles)
    for f in ("ids", "tile_starts", "tile_counts"):
        check(torch.equal(getattr(sk, f), getattr(sp, f)),
              f"{what}: sorted {f}")
    max_err = float((em_k.keys - em_p.keys).abs().max())
    log(f"{what}: K1 == plain bit for bit ({int(em_k.num_pairs)} pairs, "
        f"{int(sk.tile_counts.sum())} after the cull; pairs per tile mean "
        f"{float(sk.tile_counts.float().mean()):.0f}, max "
        f"{int(sk.tile_counts.max())})")
    return sk, max_err


def phase_kernels_vs_plain():
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_cuda,
                                                   emission_plain)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import composite_plain

    W = H = 256
    cfg = RasterizerConfig(pair_capacity=1 << 18)
    R, t = look_at((0.0, 0.0, -3.0))
    cam = make_camera(R.T, t, math.radians(60), math.radians(60), W, H)
    model = GaussianModel(params_from_numpy(sphere_scene(20_000, seed=1)), 3)
    inp = model.raster_inputs()
    with torch.no_grad():
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam, 3, cfg)
        feat9 = build_feat9(prep)
        args = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        gx, gy = cfg.grid_size(W, H)
        pairs, _ = compare_emission(emission_cuda(*args),
                                    emission_plain(*args), gx * gy,
                                    "20k/256x256")
        check(int(pairs.tile_counts.float().mean()) >= 100,
              "phase 3 scene gives hundreds of pairs per tile")
        pin = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H,
               cfg)
        color_k, T_k = composite_cuda(*pin)
        plain = composite_plain(*pin, max_per_tile=int(pairs.tile_counts.max()))
        torch.cuda.synchronize()
        compare_composite(color_k, T_k, plain.color, plain.final_T,
                          "20k/256x256")


def write_colmap_model(sparse, n_views, width, height, fx):
    from gs2mesh_torch.core import colmap_io
    from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz

    cams = {1: colmap_io.ColmapCamera(
        id=1, model="PINHOLE", width=width, height=height,
        params=np.array([fx, fx, width / 2, height / 2]))}
    images = {}
    for i in range(n_views):
        ang = 0.35 * (i - (n_views - 1) / 2)
        R, t = look_at((3.0 * math.sin(ang), 0.3 * (i % 2), -3.0 * math.cos(ang)))
        images[i + 1] = colmap_io.ColmapImage(
            id=i + 1, qvec=rotmat2qvec_wxyz(R), tvec=t, camera_id=1,
            name=f"{i:03}.png", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64))
    colmap_io.write_model_text(sparse, cams, images, {})


def phase_main_path(work):
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda
    from gs2mesh_torch.pipeline import PipelineArgs, Renderer

    n_gauss, W, H, n_views = 300_000, 960, 576, 4
    ply = os.path.join(work, "point_cloud.ply")
    GaussianModel(params_from_numpy(sphere_scene(n_gauss, seed=0),
                                    device="cpu"), 3).save_ply(ply)
    colmap_dir = os.path.join(work, "colmap")
    write_colmap_model(os.path.join(colmap_dir, "sparse", "0"), n_views, W,
                       H, fx=W / (2 * math.tan(math.radians(30))))
    out_root = os.path.join(work, "renders")
    r = Renderer(work, colmap_dir, out_root,
                 PipelineArgs.for_dataset("custom", colmap_name="smoke"),
                 ply_path=ply, device="cuda")
    r.prepare_renderer()          # default pair_capacity 1 << 22
    check(len(r) == n_views, "views")

    renders = []
    plain_render = r.render_single

    def timed_render(cam):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = plain_render(cam)
        torch.cuda.synchronize()
        renders.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                            num_pairs=int(r.last_output.num_pairs),
                            overflow=bool(r.last_output.overflow),
                            k1=emission_cuda.launches,
                            k2=composite_cuda.launches))
        return img

    plain_render(r.cameras[0]["left"])            # warm-up
    r.render_single = timed_render
    emission_cuda.launches = composite_cuda.launches = 0
    images = [r.render_image_pair(i) for i in range(n_views)]
    launches = {"emit": emission_cuda.launches,
                "composite": composite_cuda.launches}
    r.render_single = plain_render

    for k, rec in enumerate(renders):
        log(f"render {k} ({'left' if k % 2 == 0 else 'right'} of view "
            f"{k // 2}): {rec['ms']:.3f} ms, num_pairs {rec['num_pairs']}, "
            f"overflow {rec['overflow']}, launches so far K1 {rec['k1']} "
            f"K2 {rec['k2']}")
    log(f"main path launches: K1 {launches['emit']}, K2 "
        f"{launches['composite']} over {len(renders)} renders")
    check(len(renders) == 2 * n_views, "8 renders")
    check(launches["emit"] == launches["composite"] == len(renders),
          f"kernel launches {launches} != {len(renders)} renders")
    check(not any(rec["overflow"] for rec in renders), "pair overflow")
    for i, pair in enumerate(images):
        for side in ("left", "right"):
            img = pair[side]
            check(img.shape == (H, W, 3) and np.isfinite(img).all(),
                  f"view {i} {side}: shape / finite")
            check(0.02 < float(img.mean()) < 0.98, f"view {i} {side}: mean")
            check(os.path.getsize(os.path.join(r.render_folder_name(i),
                                               f"{side}.png")) > 1000,
                  f"view {i} {side}.png")
        check(float(np.abs(pair["left"] - pair["right"]).mean()) > 0,
              f"view {i}: left == right")
    return r, renders, launches


def phase_timings(r, launches):
    """K1 and K2 at the main path's shapes (view 0, left), each beside its
    plain version on the same inputs."""
    from gs2mesh_torch.core.camera import camera_from_euler
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_cuda,
                                                   emission_plain,
                                                   sort_pairs)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import composite_plain

    c = r.cameras[0]["left"]
    W, H = c["width"], c["height"]
    cam = camera_from_euler(c["rot"], c["pos"], c["fx"], c["fy"], W, H)
    cfg, inp = r._cfg, r._inputs
    N, K = inp["means3d"].shape[0], cfg.pair_capacity
    gx, gy = cfg.grid_size(W, H)
    with torch.no_grad():
        def run_preprocess():
            return preprocess(inp["means3d"], inp["scales"],
                              inp["rotations"], inp["opacities"],
                              inp["shs"], cam, 3, cfg)

        prep = run_preprocess()
        feat9 = build_feat9(prep)
        eargs = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        em = emission_cuda(*eargs)
        pairs, k1_err = compare_emission(em, emission_plain(*eargs), gx * gy,
                                         "300k/960x576")
        cargs = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W,
                 H, cfg)
        color_k, T_k = composite_cuda(*cargs)
        mpt = int(pairs.tile_counts.max())
        plain = composite_plain(*cargs, max_per_tile=mpt)
        k2_err = compare_composite(color_k, T_k, plain.color, plain.final_T,
                                   "300k/960x576")

        t = dict(
            preprocess=cuda_time_ms(run_preprocess, 20),
            k1=cuda_time_ms(lambda: emission_cuda(*eargs), 50),
            k1_plain=cuda_time_ms(lambda: emission_plain(*eargs), 5),
            sort=cuda_time_ms(lambda: sort_pairs(em, gx * gy), 20),
            k2=cuda_time_ms(lambda: composite_cuda(*cargs), 50),
            k2_plain=cuda_time_ms(
                lambda: composite_plain(*cargs, max_per_tile=mpt), 2))
    log("device ms per stage at 300k/960x576 (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))

    n_live = int(pairs.tile_counts.sum())
    n_eval = int(plain.n_evaluated)
    k1_bytes = N * (36 + 4 + 16 + 4) + K * (8 + 4)
    k2_bytes = n_live * 4 + gx * gy * 8 + N * 36 + 4 * W * H * 4
    k2_ops = n_eval * K2_OPS_PER_EVAL
    log(f"K2 work: {n_live} live pairs, {n_eval} (pair, pixel) evaluations "
        f"({n_eval / (W * H):.1f} per pixel), {k2_ops} FP32 ops, "
        f"{k2_bytes} bytes; K1 bytes {k1_bytes}")

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    rows = []
    for name, src, replaces, key, err, (nb, nops) in (
            ("emit_pairs", "gs2mesh_torch/csrc/emit.cu",
             "gs2mesh_tpu/ops/rasterizer/emit.py:191", "emit", k1_err,
             (k1_bytes, 0)),
            ("composite_forward", "gs2mesh_torch/csrc/composite.cu",
             "gs2mesh_tpu/ops/rasterizer/pallas_kernels.py:184",
             "composite", k2_err, (k2_bytes, k2_ops))):
        bms, by = bound(nb, nops)
        short = "k1" if key == "emit" else "k2"
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": err, "ms": t[short],
                     "plain_ms": t[short + "_plain"], "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
    return rows


def phase_profile(r, n=3):
    """torch.profiler over n renders of view 0: device-busy share of the
    render wall time and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    cam = r.cameras[0]["left"]
    r.render_single(cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            r.render_single(cam)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile over {n} renders: wall {wall_us / n / 1e3:.3f} ms/render, "
        f"device busy {busy_us / n / 1e3:.3f} ms/render, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / n / 1e3:8.4f} ms/render "
            f"x{e.count // n:<3d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "one CUDA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain compositor bmm
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from gs2mesh_torch import _build

    t0 = time.perf_counter()
    _build.library("emit")          # builds every csrc/*.cu
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, out in sorted(_build.build_log.items()):
        log(f"--- nvcc {name}.cu ---\n{out.strip()}")

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    phase_kernels_vs_plain()
    log(f"phase kernels-vs-plain: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    r, renders, launches = phase_main_path(work)
    log(f"phase main path: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows = phase_timings(r, launches)
    phase_profile(r)
    log(f"phase timings + profile: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(work)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
