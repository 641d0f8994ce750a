#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gs2mesh_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --save-forward DIR      # also keep K1's and K2's
                                                  # inputs and outputs
    python3 chip_smoke.py --replay-forward DIR    # K1 and K2 of this tree on
                                                  # those inputs, nothing else

To hold another tree's K1 and K2 (the parent commit's, an ablated copy's) to
this one's on one card, copy that tree's gs2mesh_torch/ and this script into
a directory of its own, run the full script here with --save-forward, then
the copy's with --replay-forward on the same DIR: it times K1, K2 and K2 on
the heaviest tile alone on the saved inputs and fails unless its keys, ids,
colour and final_T equal the saved ones bit for bit.

Phases (any failure raises, and the script exits non-zero):
  1. needs torch.cuda; prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from gs2mesh_torch/csrc with nvcc (timed);
  3. kernel vs plain on the card, on a seeded 20k-gaussian SH-3 scene at
     256x256: K1 (emission) keys / ids bit for bit after the stable sort,
     K2 (compositing) image and final_T within 2e-5 on >= 99.99% of values
     and every larger difference <= 4e-3 (one 1/255 knife-edge or T-stop
     flip), bit-identical across two runs; K3 (compositing backward) and
     K4 (per-gaussian sum) against the plain autograd and the plain sum
     (tolerances at compare_backward), each bit-identical across two runs,
     K4 also bit for bit against the float32 slot-order sum; then K1-K4
     again, the same checks, on a 60k-gaussian scene of splats a few pixels
     wide at 360x200 (ragged last tile row and column), where K2's and
     K3's sub-box mask and K3's empty-pair branches do the work;
  4. the main path at full width: a seeded 300k-gaussian SH-3 model written
     as a GS PLY, a 4-view COLMAP text model at 960x576, and the port's
     Renderer on cuda rendering the 4 stereo pairs to PNG; K1 and K2 must
     each launch once per render, with no pair overflow;
  5. K1 and K2 timed beside their plain versions at the main path's shapes,
     K2 also on its heaviest tile alone and bit-identical across two runs;
     K3 and K4 timed on that dense render too (2.9M live pairs; K4 beside
     one index_add_), bit-identical across two runs, K4 against the plain
     and the slot-order sums;
 5b. the stereo stage on the served views: a seeded DLNR on the card
     against the CPU at 128x192, 2 iterations, cold and with a flow so
     negative that the refinement runs (float64 within 1e-8 of the largest
     |disparity|; float32 with TF32 off within 1e-4 of it or 4x the CPU's
     own float32 error against float64; each branch printed), its bf16
     policy against float32 on the card (< 0.15); then Stereo.run() over the
     4 views at 960x576, 10 iterations, [LR, RL] in one batch, warm start,
     in float32 and in bf16: per-view wall and forward device ms, K1 and K2
     twice a view, peak memory, every artifact's dtype and shape and a
     finite disparity; each run again under torch.profiler for the
     stereo.* / dlnr.* range breakdown and the device idle share; the
     forward's convolution and matmul FLOPs and TFLOP/s against the H100's
     FP32 / TF32 / bf16 peaks;
  6. the training path at full width: 8 target views of the 300k SH-3
     sphere rendered by the port at 960x576 and written as PNGs with a
     binary COLMAP model holding the 300k centres; load_colmap_scene ->
     GaussianModel.from_point_cloud -> Trainer(device="cuda"), 20
     iterations from 3090 (active SH degree 3, a densify at 3100), an
     opacity reset and 5 more; K1-K4 must launch once per taken step, with
     no overflow, a finite and falling loss, > 90% of the alive rows kept
     by the densify, and finite params and Adam moments;
  7. 3 more steps of the trainer under torch.profiler: the device idle
     share and each train_step range's device and host ms; then K1 and K2
     (against their plain versions, timed, K2 on its heaviest tile alone)
     and K3 and K4 at the step's shapes beside their plain versions (K4
     also beside one index_add_); all four kernels printed as one JSON
     "kernels" line (K1 and K2 with their stereo launches);
  8. last line: {"ok": true, "device": {...}}.
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
# FP32 operations per (pair, pixel) evaluation, in K2 and K3 alike: 2 for
# dx/dy, 7 for the conic power, 4 for expf (range reduction + polynomial),
# 1 for the opacity product and 1 for the 1/255 test. Only the evaluations
# the plain compositor counts as accepted (composited) do more:
OPS_PER_EVAL = 15
# K2: the clamp, 1 - alpha, the T product, the T-stop test, w = alpha*T and
# 3 multiply-adds into the colour.
K2_OPS_PER_ACCEPTED = 11
# K3: K2's first 5 (clamp, T update, T-stop test, w), 5 for u, 2 for the
# running sum, 4 for dalpha, 1 for dpower, 23 for the nine gradient terms
# and 9 adds of them into the pair's sums (the least a sum over the pair's
# pixels needs, whatever the reduction tree).
K3_OPS_PER_ACCEPTED = 49
# K1, FP32 operations per emitted slot: 6 for the tile box's four edges
# relative to the mean, 4 compares for "mean inside", 14 for each of the four
# edge minima (the clamped 1-D minimiser with its division, then the conic
# quadratic), 3 minima, 6 for op * exp(-qmin) against the cut.
K1_OPS_PER_SLOT = 75

SAVE_FORWARD_DIR = None       # --save-forward: where phases 5 and 7 keep
                              # K1's and K2's inputs and outputs


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a):
    print(*a, flush=True)


def compositor_ops(plain, ops_per_accepted):
    """FP32 operations a compositor needs for this run's data, from the
    plain compositor's evaluated and accepted (pair, pixel) counts."""
    return (int(plain.n_evaluated) * OPS_PER_EVAL
            + int(plain.n_accepted) * ops_per_accepted)


def cuda_time_ms(fn, iters, warm=True, queued=False):
    """Mean device time of fn() over iters launches, after one warm-up
    (skipped with warm=False, for plain versions already run once). With
    queued=True (the kernels) the timed launches are queued behind a ~20 ms
    matrix product, so a kernel that runs shorter than Python takes to
    launch it is timed by the device, not by the host's enqueue rate."""
    if warm:
        fn()
    blocker = torch.ones((8192, 8192), device="cuda") if queued else None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.mm(blocker, blocker)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sphere_scene(n, seed, sh_degree=3, scale=(0.04, 0.012)):
    """The bench sphere (__graft_entry__._scene) with small nonzero
    higher-order SH; numpy arrays in GaussianParams layout. scale is the
    mean and spread of the splats' world-space sigmas."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scales = np.abs(rng.normal(*scale, size=(n, 3))) + 1e-3
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


def run_forward_kernels(eargs):
    """K1 -> stable sort -> K2 on emission inputs (feat9, depths, rect,
    tiles_touched, W, H, cfg). Returns (emission, sorted pairs, colour,
    final_T)."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda, sort_pairs

    feat9, W, H, cfg = eargs[0], *eargs[4:]
    em = emission_cuda(*eargs)
    gx, gy = cfg.grid_size(W, H)
    pairs = sort_pairs(em, gx * gy)
    color, final_T = composite_cuda(pairs.ids, pairs.tile_starts,
                                    pairs.tile_counts, feat9, W, H, cfg)
    return em, pairs, color, final_T


def time_forward_kernels(eargs, what):
    """K1 and K2 on these inputs: run twice (bit-identical), then both
    timed, K2 also on the tile with the most pairs alone (a tile's pairs are
    walked in order, so no launch is shorter than its slowest tile). K1's
    time is its wrapper's: the prefix sum of tiles_touched and the sentinel
    key (a few small PyTorch kernels) and the kernel; the profiles give the
    kernel alone. Returns (emission, sorted pairs, colour, final_T, ms by
    name)."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda

    feat9, W, H, cfg = eargs[0], *eargs[4:]
    em, pairs, color, final_T = run_forward_kernels(eargs)
    em2, _, color2, final_T2 = run_forward_kernels(eargs)
    torch.cuda.synchronize()
    check(torch.equal(em.keys, em2.keys) and torch.equal(em.ids, em2.ids),
          f"{what}: K1 bit-identical across two runs")
    check(torch.equal(color, color2) and torch.equal(final_T, final_T2),
          f"{what}: K2 bit-identical across two runs")
    check(bool(torch.isfinite(color).all() & torch.isfinite(final_T).all()),
          f"{what}: K2 outputs finite")
    del em2, color2, final_T2
    cargs = (pairs.ids, pairs.tile_starts)
    rest = (feat9, W, H, cfg)
    heaviest = int(pairs.tile_counts.argmax())
    alone = torch.zeros_like(pairs.tile_counts)
    alone[heaviest] = pairs.tile_counts[heaviest]
    ms = dict(
        k1=cuda_time_ms(lambda: emission_cuda(*eargs), 50, queued=True),
        k2=cuda_time_ms(lambda: composite_cuda(*cargs, pairs.tile_counts,
                                               *rest), 50, queued=True),
        k2_heaviest_tile=cuda_time_ms(
            lambda: composite_cuda(*cargs, alone, *rest), 20, queued=True))
    counts = pairs.tile_counts.float()
    log(f"{what}: K1 {ms['k1']:.4f} ms, K2 {ms['k2']:.4f} ms, both "
        f"bit-identical across two runs; pairs per tile mean "
        f"{float(counts.mean()):.0f}, max {int(counts.max())}; K2 on that "
        f"heaviest tile alone {ms['k2_heaviest_tile']:.4f} ms")
    return em, pairs, color, final_T, ms


def forward_case_path(name):
    return os.path.join(SAVE_FORWARD_DIR,
                        name.replace(" ", "_").replace("/", "_") + ".pt")


def save_forward_case(name, eargs, em, color, final_T):
    """With --save-forward: K1's and K2's inputs and outputs, for another
    tree's --replay-forward."""
    if SAVE_FORWARD_DIR is None:
        return
    feat9, depths, rect, tiles_touched, W, H, cfg = eargs
    os.makedirs(SAVE_FORWARD_DIR, exist_ok=True)
    torch.save(dict(name=name, feat9=feat9, depths=depths, rect=rect,
                    tiles_touched=tiles_touched, width=W, height=H,
                    pair_capacity=cfg.pair_capacity, keys=em.keys,
                    ids=em.ids, color=color, final_T=final_T),
               forward_case_path(name))
    log(f"{name}: forward case saved to {forward_case_path(name)}")


def replay_forward(case_dir):
    """--replay-forward: this tree's K1 and K2 on every case saved in
    case_dir, timed, and held bit for bit to the saved outputs. One JSON
    line per case."""
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig

    cases = sorted(f for f in os.listdir(case_dir) if f.endswith(".pt"))
    check(cases, f"no saved forward case in {case_dir}")
    for f in cases:
        c = torch.load(os.path.join(case_dir, f), map_location="cuda")
        cfg = RasterizerConfig(pair_capacity=c["pair_capacity"])
        eargs = (c["feat9"], c["depths"], c["rect"], c["tiles_touched"],
                 c["width"], c["height"], cfg)
        with torch.no_grad():
            em, _, color, final_T, ms = time_forward_kernels(eargs, c["name"])
        same = dict(k1=torch.equal(em.keys, c["keys"])
                    and torch.equal(em.ids, c["ids"]),
                    k2=torch.equal(color, c["color"])
                    and torch.equal(final_T, c["final_T"]))
        print(json.dumps({"forward_case": c["name"], "ms": ms,
                          "equal_to_saved": same}), flush=True)
        check(same["k1"], f"{c['name']}: K1 keys / ids differ from the saved")
        check(same["k2"], f"{c['name']}: K2 colour / final_T differ from "
              f"the saved")


def phase_kernels_vs_plain(what, n, W, H, scale, min_pairs_per_tile):
    """K1 and K2 against their plain versions on a seeded sphere scene."""
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_cuda,
                                                   emission_plain)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_plain, pair_box_mask_plain, pair_rows)

    cfg = RasterizerConfig(pair_capacity=1 << 18)
    R, t = look_at((0.0, 0.0, -3.0))
    fov = math.radians(60)
    cam = make_camera(R.T, t, fov, 2 * math.atan(H / W * math.tan(fov / 2)),
                      W, H)
    model = GaussianModel(params_from_numpy(
        sphere_scene(n, seed=1, scale=scale)), 3)
    inp = model.raster_inputs()
    with torch.no_grad():
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam, 3, cfg)
        feat9 = build_feat9(prep)
        args = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        gx, gy = cfg.grid_size(W, H)
        pairs, _ = compare_emission(emission_cuda(*args),
                                    emission_plain(*args), gx * gy, what)
        check(not bool(pairs.overflow), f"{what}: pair overflow")
        check(int(pairs.tile_counts.float().mean()) >= min_pairs_per_tile,
              f"{what}: at least {min_pairs_per_tile} pairs per tile")
        pin = (pairs.ids, pairs.tile_starts, pairs.tile_counts, feat9, W, H,
               cfg)
        color_k, T_k = composite_cuda(*pin)
        color_2, T_2 = composite_cuda(*pin)
        rows = pair_rows(feat9, pairs.ids)
        plain = composite_plain(
            rows, pairs.tile_starts, pairs.tile_counts, W, H, cfg,
            int(pairs.tile_counts.max()), box_mask=pair_box_mask_plain(
                rows, pairs.tile_starts, pairs.tile_counts, W, H, cfg))
        torch.cuda.synchronize()
        check(torch.equal(color_k, color_2) and torch.equal(T_k, T_2),
              f"{what}: K2 bit-identical across two runs")
        compare_composite(color_k, T_k, plain.color, plain.final_T, what)
    log_k3_evaluations(what, plain)
    return what, pairs, feat9, prep, color_k, T_k, W, H, cfg


def log_k3_evaluations(what, plain):
    """The (pair, pixel) evaluations of the plain compositor (every pixel
    of a tile, each pair until the pixel stops: what K2's and K3's bounds
    count) beside those K2 and K3 make (whole 8x4 sub-boxes: the ones a
    pair's mask keeps and in which a pixel still evaluates it)."""
    ev, acc, box = (int(plain.n_evaluated), int(plain.n_accepted),
                    int(plain.n_box_evaluated))
    log(f"{what}: per-pixel evaluations {ev}, accepted {acc} "
        f"({100 * acc / max(ev, 1):.2f}%); K2 and K3 evaluate whole sub-boxes: "
        f"{box} ({100 * box / max(ev, 1):.2f}% of the per-pixel count, "
        f"{100 * acc / max(box, 1):.2f}% of them accepted)")


def loss_cotangents(color, final_T):
    """Cotangents of loss = mean(image^2) + 0.1 * mean(final_T) with a black
    background (image == color), so both K3 inputs dC and dTf are nonzero."""
    return (2.0 * color / color.numel(),
            torch.full_like(final_T, 0.1 / final_T.numel()))


def run_backward_kernels(pairs, feat9, tiles_touched, color, final_T, dC, dT,
                         W, H, cfg):
    from gs2mesh_torch.ops.rasterizer.composite import composite_backward_cuda
    from gs2mesh_torch.ops.rasterizer.emit import segment_sum_cuda

    dpairs = composite_backward_cuda(pairs.ids, pairs.order, pairs.tile_starts,
                                     pairs.tile_counts, pairs.num_pairs,
                                     feat9, color, final_T, dC, dT, W, H, cfg)
    return dpairs, segment_sum_cuda(dpairs, pairs.offsets, tiles_touched)


def emitted(pairs):
    """Slots that hold a pair: K3 leaves the rows past them unwritten."""
    return min(int(pairs.num_pairs), pairs.ids.shape[0])


def check_k4_sums(k3, k4, pairs, tiles_touched, what):
    """K4 against the plain float64 sum of the same K3 rows (within 1e-5
    relative plus 1e-6 of the largest value, every value) and against the
    float32 slot-order sum (bit for bit). Returns the max abs error."""
    from gs2mesh_torch.ops.rasterizer.emit import (segment_sum_plain,
                                                   segment_sum_slot_order)

    sum4 = segment_sum_plain(k3, pairs.offsets, tiles_touched)
    gap4 = (k4 - sum4).abs()
    k4_err = float(gap4.max())
    ok4 = bool((gap4 <= 1e-5 * sum4.abs()
                + 1e-6 * float(sum4.abs().max())).all())
    strict = torch.equal(k4, segment_sum_slot_order(k3, pairs.offsets,
                                                    tiles_touched))
    log(f"{what}: K4 vs plain on the same K3 rows: {gap4.numel()} values, "
        f"max abs err {k4_err:.3e}, all within tolerance: {ok4}; equal to "
        f"the float32 slot-order sum bit for bit: {strict}")
    check(ok4, f"{what}: K4 disagrees")
    check(strict, f"{what}: K4 differs from the slot-order sum")
    return k4_err


def run_backward_plain(pairs, feat9, dC, dT, W, H, cfg):
    """The plain autograd's per-pair gradients (K, 9) at emission slots."""
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_backward_plain, pair_rows)

    dpairs = torch.zeros((pairs.ids.shape[0], 9), dtype=torch.float32,
                         device=feat9.device)
    dpairs[pairs.order] = composite_backward_plain(
        pair_rows(feat9, pairs.ids), pairs.tile_starts, pairs.tile_counts,
        dC, dT, W, H, cfg, int(pairs.tile_counts.max()))
    return dpairs


def compare_backward(k3, k4, plain3, pairs, tiles_touched, what):
    """K3 against the plain autograd on the live pair rows (nonzero in
    either; every other row is zero in both). A value is within tolerance
    if it is within 2e-3 relative plus 1e-4 of its column's largest
    magnitude (K3 sums each pair's 1024 pixels in another order than the
    plain bmm and sums). >= 99.9% of the live values must be, and none may
    be more than 1e-3 of its column's largest magnitude apart: the rest can
    only be 1/255 or T-stop knife edges, where the plain torch.exp and
    log-space T decide a pixel apart from the kernel and move a pair's sum
    by that pixel's share. Only the emitted slots are compared (the plain
    rows past them must be zero; K3 leaves its own unwritten). K4 as
    check_k4_sums says. The chained K3 + K4 against the plain sum of the
    plain rows is printed beside them."""
    from gs2mesh_torch.ops.rasterizer.emit import segment_sum_plain

    n_emitted = emitted(pairs)
    check(not bool(plain3[n_emitted:].ne(0).any()),
          f"{what}: plain rows past the emitted slots are zero")
    k3_all, k3, plain3 = k3, k3[:n_emitted], plain3[:n_emitted]
    live = plain3.ne(0).any(1) | k3.ne(0).any(1)
    ref = plain3[live]
    scale = plain3.abs().amax(0)
    gap = (k3[live] - ref).abs()
    share = float((gap <= 2e-3 * ref.abs() + 1e-4 * scale).float().mean())
    rel_gap = float((gap / scale.clamp_min(1e-30)).max())
    k3_err = float(gap.max())
    log(f"{what}: K3 vs plain: {int(live.sum())} live pair rows of "
        f"{live.numel()}, {gap.numel()} values, {100 * share:.5f}% within "
        f"tolerance, max abs err {k3_err:.3e} (largest gap / column max "
        f"{rel_gap:.3e})")
    check(share >= 0.999, f"{what}: K3 agrees on {share:.6f} < 0.999")
    check(rel_gap <= 1e-3, f"{what}: K3 gap {rel_gap:.3e} of a column max")
    k4_err = check_k4_sums(k3_all, k4, pairs, tiles_touched, what)
    chained = segment_sum_plain(plain3, pairs.offsets, tiles_touched)
    log(f"{what}: K3 + K4 vs the plain sum of the plain rows: max abs err "
        f"{float((k4 - chained).abs().max()):.3e} (largest value "
        f"{float(chained.abs().max()):.3e})")
    return k3_err, k4_err


def phase_backward_vs_plain(what, pairs, feat9, prep, color, final_T, W, H,
                            cfg):
    """K3 and K4 against their plain versions on a phase 3 scene, and each
    bit-identical across two runs."""
    dC, dT = loss_cotangents(color, final_T)
    args = (pairs, feat9, prep.tiles_touched, color, final_T, dC, dT, W, H,
            cfg)
    with torch.no_grad():
        k3a, k4a = run_backward_kernels(*args)
        k3b, k4b = run_backward_kernels(*args)
        torch.cuda.reset_peak_memory_stats()
        plain3 = run_backward_plain(pairs, feat9, dC, dT, W, H, cfg)
        torch.cuda.synchronize()
    log(f"{what}: plain backward peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    n = emitted(pairs)
    check(torch.equal(k3a[:n], k3b[:n]),
          f"{what}: K3 bit-identical across two runs")
    check(torch.equal(k4a, k4b), f"{what}: K4 bit-identical across two runs")
    log(f"{what}: K3 and K4 bit-identical across two runs")
    return compare_backward(k3a, k4a, plain3, pairs, prep.tiles_touched, what)


def write_colmap_model(sparse, n_views, width, height, fx, points=None,
                       binary=False):
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
    write = colmap_io.write_model_binary if binary else \
        colmap_io.write_model_text
    write(sparse, cams, images, points or {})


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


def bench_points(d):
    """COLMAP points3D of a sphere_scene dict: the centres and their DC
    colours as 8-bit RGB."""
    from gs2mesh_torch.core.colmap_io import ColmapPoint3D
    from gs2mesh_torch.core.sh import C0

    rgb = np.clip((d["features_dc"][:, 0] * C0 + 0.5) * 255.0, 0, 255)
    empty = np.zeros((0,), np.int64)
    return {i + 1: ColmapPoint3D(i + 1, xyz, c, 0.0, empty, empty)
            for i, (xyz, c) in enumerate(zip(d["xyz"].astype(np.float64),
                                              rgb.round().astype(np.uint8)))}


def bound(nbytes, nops):
    """Least time (ms) for the work on the card and what sets it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def emission_work(n_gauss, capacity, num_pairs):
    """K1's bytes (60 per gaussian in, a key and an id per slot of the
    capacity out) and FP32 operations (the box test of every emitted
    slot)."""
    return (n_gauss * (36 + 4 + 16 + 4) + capacity * (8 + 4),
            min(num_pairs, capacity) * K1_OPS_PER_SLOT)


def forward_composite_work(n_live, n_tiles, n_gauss, n_pixels, plain):
    """K2's bytes (an id per live pair, a range per tile, every feat9 row
    once, four floats per pixel out) and FP32 operations, from the plain
    compositor's evaluated and accepted counts."""
    return (n_live * 4 + n_tiles * 8 + n_gauss * 36 + 4 * n_pixels * 4,
            compositor_ops(plain, K2_OPS_PER_ACCEPTED))


def log_emission_bounds(what, nbytes, nops):
    log(f"{what}: K1 work {nbytes} bytes, {nops} FP32 ops: byte bound "
        f"{bound(nbytes, 0)[0]:.4f} ms, operation bound "
        f"{bound(0, nops)[0]:.4f} ms")


def backward_rows(train_t, dense_t, launches):
    """K3's and K4's rows of the kernels line: the training step's numbers
    under the common keys, the dense serving render's under dense_*."""
    rows = []
    for name, src, replaces, key in (
            ("composite_backward", "gs2mesh_torch/csrc/composite.cu",
             "gs2mesh_tpu/ops/rasterizer/pallas_kernels.py:271", "k3"),
            ("segment_sum", "gs2mesh_torch/csrc/segsum.cu",
             "gs2mesh_tpu/ops/rasterizer/emit.py:659", "k4")):
        ms, plain_ms, library_ms, err, nbytes, nops = train_t[key]
        bms, by = bound(nbytes, nops)
        d_ms, d_library_ms, d_bytes, d_ops = dense_t[key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches[key.upper()], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": library_ms,
                     "dense_ms": d_ms,
                     "dense_bound_ms": bound(d_bytes, d_ops)[0]})
        if d_library_ms is not None:
            rows[-1]["dense_library_ms"] = d_library_ms
    # K3 also stands for the compact form of the same TPU kernel body.
    rows[0]["also_replaces"] = \
        "gs2mesh_tpu/ops/rasterizer/pallas_kernels.py:704"
    return rows


def time_backward_kernels(pairs, feat9, tiles_touched, color, final_T, dC, dT,
                          W, H, cfg, what):
    """K3 (with its fill) and K4 on these inputs: run twice (bit-identical),
    then both timed, K4 beside the one PyTorch call that computes the same
    sum; K3 also on the tile with the most pairs alone (a tile's pairs are
    walked in order, so no launch is shorter than its heaviest tile).
    Returns (k3 rows, k4 sums, K3 ms, K4 ms, index_add_ ms)."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_backward_cuda
    from gs2mesh_torch.ops.rasterizer.emit import segment_sum_cuda

    bargs = (pairs, feat9, tiles_touched, color, final_T, dC, dT, W, H, cfg)
    k3, k4 = run_backward_kernels(*bargs)
    k3b, k4b = run_backward_kernels(*bargs)
    torch.cuda.synchronize()
    n = emitted(pairs)
    check(torch.equal(k3[:n], k3b[:n]) and torch.equal(k4, k4b),
          f"{what}: K3 and K4 bit-identical across two runs")
    check(bool(torch.isfinite(k3[:n]).all()), f"{what}: K3 rows finite")
    del k3b, k4b
    k3_ms = cuda_time_ms(lambda: composite_backward_cuda(
        pairs.ids, pairs.order, pairs.tile_starts, pairs.tile_counts,
        pairs.num_pairs, feat9, color, final_T, dC, dT, W, H, cfg), 20,
        queued=True)
    k4_ms = cuda_time_ms(lambda: segment_sum_cuda(
        k3, pairs.offsets, tiles_touched), 50, queued=True)
    heaviest = int(pairs.tile_counts.argmax())
    alone = torch.zeros_like(pairs.tile_counts)
    alone[heaviest] = pairs.tile_counts[heaviest]
    alone_ms = cuda_time_ms(lambda: composite_backward_cuda(
        pairs.ids, pairs.order, pairs.tile_starts, alone, pairs.num_pairs,
        feat9, color, final_T, dC, dT, W, H, cfg), 10, queued=True)
    counts = pairs.tile_counts.float()
    log(f"{what}: pairs per tile mean {float(counts.mean()):.0f}, max "
        f"{int(counts.max())}; K3 on that heaviest tile alone "
        f"{alone_ms:.4f} ms of {k3_ms:.4f} ms for all "
        f"{int((counts > 0).sum())} tiles with pairs")
    # One PyTorch call for K4's sum over the emitted slots: slot s adds into
    # the row of the gaussian that owns it.
    owner = torch.repeat_interleave(
        torch.arange(tiles_touched.shape[0], device=k3.device),
        tiles_touched.to(torch.int64))[:n]
    rows = k3[:n]
    lib = torch.zeros_like(k4)
    lib_ms = cuda_time_ms(lambda: lib.index_add_(0, owner, rows), 50,
                          queued=True)
    lib_err = float((torch.zeros_like(k4).index_add_(0, owner, rows)
                     - k4).abs().max())
    log(f"{what}: K3 {k3_ms:.4f} ms (fill included), K4 {k4_ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms (differs from K4 by at most "
        f"{lib_err:.3e})")
    return k3, k4, k3_ms, k4_ms, lib_ms


def kernel_counts():
    from gs2mesh_torch.ops.rasterizer.composite import (
        composite_backward_cuda, composite_cuda)
    from gs2mesh_torch.ops.rasterizer.emit import (emission_cuda,
                                                   segment_sum_cuda)

    return {"K1": emission_cuda, "K2": composite_cuda,
            "K3": composite_backward_cuda, "K4": segment_sum_cuda}


def phase_train(work):
    """The training path at full width through the normal entry points:
    8 target views of the 300k SH-3 bench sphere rendered by the port at
    960x576 and written as PNGs with a binary COLMAP model whose points3D
    hold the 300k centres; load_colmap_scene -> from_point_cloud ->
    Trainer(device="cuda"); 20 iterations from 3090 (active SH degree 3,
    a densify at 3100), then an opacity reset and 5 more."""
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.core.png import write_png
    from gs2mesh_torch.core.transforms import qvec2rotmat_wxyz
    from gs2mesh_torch.core import colmap_io
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
    from gs2mesh_torch.train.scene import load_colmap_scene
    from gs2mesh_torch.train.trainer import TrainConfig, Trainer

    n_gauss, W, H, n_views = 300_000, 960, 576, 8
    fov = math.radians(60)
    fx = W / (2 * math.tan(fov / 2))
    d = sphere_scene(n_gauss, seed=0)
    colmap_dir = os.path.join(work, "train_scene")
    sparse = os.path.join(colmap_dir, "sparse", "0")
    write_colmap_model(sparse, n_views, W, H, fx, points=bench_points(d),
                       binary=True)
    os.makedirs(os.path.join(colmap_dir, "images"))
    target = GaussianModel(params_from_numpy(d), 3).raster_inputs()
    rcfg = RasterizerConfig(pair_capacity=1 << 22)
    with torch.no_grad():
        for im in colmap_io.read_images_binary(
                os.path.join(sparse, "images.bin")).values():
            R = qvec2rotmat_wxyz(im.qvec)
            cam = make_camera(R.T, im.tvec, fov, 2 * math.atan(H / (2 * fx)),
                              W, H)
            out = rasterize(target["means3d"], target["scales"],
                            target["rotations"], target["opacities"],
                            target["shs"], cam, 3, cfg=rcfg)
            check(not bool(out.overflow), "target render overflow")
            img = (out.image.clamp(0, 1) * 255).round().to(torch.uint8)
            write_png(os.path.join(colmap_dir, "images", im.name),
                      img.permute(1, 2, 0).cpu().numpy())
    del target

    t0 = time.perf_counter()
    scene = load_colmap_scene(colmap_dir, device="cuda")
    check(len(scene.cameras) == n_views and scene.points.shape[0] == n_gauss,
          "scene views / points")
    model = GaussianModel.from_point_cloud(
        scene.points, scene.colors, spatial_lr_scale=scene.nerf_norm_radius,
        device="cuda")
    trainer = Trainer(model=model, cameras=scene.cameras, images=scene.images,
                      cfg=TrainConfig(), rcfg=rcfg,
                      scene_extent=scene.nerf_norm_radius, device="cuda")
    torch.cuda.synchronize()
    log(f"train set-up: load_colmap_scene + from_point_cloud + Trainer "
        f"{time.perf_counter() - t0:.2f} s; capacity {model.capacity}, "
        f"scene extent {scene.nerf_norm_radius:.4f}")

    steps = []

    def record(tr, out):
        torch.cuda.synchronize()
        steps.append(dict(it=tr.iteration, t=time.perf_counter(),
                          loss=float(out.loss), alive=tr.model.num_alive(),
                          pairs=int(out.num_pairs),
                          capacity=tr.model.capacity))

    trainer.iteration = 3090
    counters = kernel_counts()
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    trainer.train(20, callback=record)
    trainer.reset_opacity()
    trainer.train(5, callback=record)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}

    prev_t = t_start
    for rec in steps:
        rec["ms"] = (rec.pop("t") - prev_t) * 1e3
        prev_t += rec["ms"] / 1e3
        log(f"train it {rec['it']}: loss {rec['loss']:.6f}, "
            f"{rec['ms']:.2f} ms, pairs {rec['pairs']}, alive "
            f"{rec['alive']}, capacity {rec['capacity']}")
    n_steps = len(steps)
    plain = [r["ms"] for r in steps[1:] if r["it"] not in (3100, 3111)]
    log(f"host wall per step (steps 2-25 without the densify and reset "
        f"steps): median {np.median(plain):.2f} ms, min {min(plain):.2f}, "
        f"max {max(plain):.2f}")
    log(f"train launches over {n_steps} steps: {launches}")
    check(trainer.iteration == 3115 and n_steps == 25,
          f"25 taken steps ({n_steps}, iteration {trainer.iteration})")
    check(all(v == n_steps for v in launches.values()),
          f"K1-K4 once per taken step: {launches}")
    check(trainer.rcfg.pair_capacity == 1 << 22, "no pair overflow")
    check(trainer.model.active_sh_degree == 3, "active SH degree 3")
    losses = [rec["loss"] for rec in steps]
    check(all(math.isfinite(v) for v in losses), "finite losses")
    first, last = np.mean(losses[:4]), np.mean(losses[16:20])
    log(f"loss: first 4 steps {first:.6f}, steps 17-20 {last:.6f}, after "
        f"the opacity reset {losses[20]:.6f} -> {losses[-1]:.6f}")
    check(last < first, "loss falls over the 20 steps")
    before = next(r["alive"] for r in steps if r["it"] == 3099)
    after = next(r["alive"] for r in steps if r["it"] == 3100)
    log(f"densify at 3100: alive {before} -> {after}")
    check(after > 0.9 * before, "densify keeps > 90% of the alive rows")
    for t in trainer.model.params.tensors():
        check(bool(torch.isfinite(t).all()), "finite params")
    for st in trainer.optimizer.state.values():
        for k in ("exp_avg", "exp_avg_sq"):
            check(bool(torch.isfinite(st[k]).all()), "finite Adam moments")
    return trainer, float(np.median(plain)), launches


def step_stages(prof, n):
    """Each train_step range's host ms and device-busy ms per step, from a
    profile of n taken steps. A kernel (or copy) counts toward the range in
    which the operator that launched it started on the host clock; the
    backward's operators run on autograd's device thread, inside the
    waiting thread's backward range. K1's and K2's device time (in the
    forward) and K3's and K4's (in the backward) are also given on their
    own (own_kernel_ms). A kernel launched outside every operator, as K1
    is, belongs to no operator's list: its time is in the busy total and in
    own_kernel_ms, and in no range."""
    import bisect

    from torch.autograd import DeviceType

    from gs2mesh_torch.train.trainer import STEP_STAGES

    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name.split(".", 1)[1]) for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("train_step."))
    starts = [a for a, _, _ in ranges]
    host = dict.fromkeys(STEP_STAGES, 0.0)
    dev = dict.fromkeys(STEP_STAGES + ("outside",), 0.0)
    for a, b, stage in ranges:
        host[stage] += (b - a) / n / 1e3
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        stage = ranges[i][2] if i >= 0 and e.time_range.start < ranges[i][1] \
            else "outside"
        for k in e.kernels:
            dev[stage] += k.duration / n / 1e3
    dev.update(own_kernel_ms(prof, n))
    return host, dev


def phase_train_timings(trainer, step_wall_ms):
    """The trainer's own step split into its profiler ranges (device busy
    and host ms per step over 3 profiled steps) with the device idle
    share, also against step_wall_ms, the unprofiled median host wall of a
    step; then K3 and K4 at the step's shapes (view 0) beside their plain
    versions and, for K4, the one PyTorch call that computes the same sum."""
    from torch.profiler import ProfilerActivity, profile

    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_plain,
                                                   segment_sum_plain)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_backward_plain, composite_plain, pair_box_mask_plain,
        pair_rows)
    from gs2mesh_torch.ops.ssim import gs_loss
    from gs2mesh_torch.models.gaussians import activations
    from gs2mesh_torch.train.trainer import STEP_STAGES

    tr = trainer
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0w = time.perf_counter()
        saved = tr.iteration
        tr.train(3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0w) * 1e6
    check(tr.iteration == saved + 3, "profiled steps taken")
    busy_ms = report_profile(prof, wall_us, 3, "step")
    if busy_ms is not None:
        log(f"device busy {busy_ms:.3f} ms/step against the unprofiled "
            f"median step wall {step_wall_ms:.3f} ms: idle share "
            f"{1 - busy_ms / step_wall_ms:.3f}")
    host, dev = step_stages(prof, 3)
    attributed = sum(dev[s] for s in STEP_STAGES) + dev["outside"]
    if busy_ms is None or attributed == 0:
        log("train step stages: no device time attributed (not measured)")
    else:
        log("train step stages over 3 profiled steps, device busy ms / host "
            "ms per step: " + ", ".join(
                f"{s} {dev[s]:.4f} / {host[s]:.4f}" for s in STEP_STAGES)
            + f"; outside the ranges {dev['outside']:.4f} device ms; "
            f"attributed {attributed:.4f} of {busy_ms:.4f} busy")
        log(f"  forward device ms: K1 {dev['K1']:.4f} (in no range), K2 "
            f"{dev['K2']:.4f}, activations, preprocess and the sort "
            f"{dev['forward'] - dev['K2']:.4f}")
        log(f"  backward device ms: K3 {dev['K3']:.4f}, K4 {dev['K4']:.4f}, "
            f"loss backward and autograd through preprocess and the "
            f"activations {dev['backward'] - dev['K3'] - dev['K4']:.4f}")

    # The step's compositor inputs and its true image cotangent.
    m, cam, cfg = tr.model, tr.cameras[0], tr.rcfg
    W, H = cam.width, cam.height
    target, bg = tr._image_dev(0), tr._bg()
    with torch.no_grad():
        inp = activations(m.params, m.state.alive)
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam, 3, cfg)
        feat9 = build_feat9(prep)
        gx, gy = cfg.grid_size(W, H)
        what = "300k/960x576 train step"
        eargs = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        em, pairs, color, final_T, ft = time_forward_kernels(eargs, what)
        save_forward_case(what, eargs, em, color, final_T)
        _, k1_err = compare_emission(em, emission_plain(*eargs), gx * gy,
                                     what)
    image = (color + final_T[None] * bg[:, None, None]).requires_grad_(True)
    loss = gs_loss(image, target)
    (dC,) = torch.autograd.grad(loss, image)
    dT = (dC * bg[:, None, None]).sum(0)
    with torch.no_grad():
        k3, k4, k3_ms, k4_ms, lib4_ms = time_backward_kernels(
            pairs, feat9, prep.tiles_touched, color, final_T, dC, dT, W, H,
            cfg, what)
        plain3 = run_backward_plain(pairs, feat9, dC, dT, W, H, cfg)
        torch.cuda.synchronize()
        k3_err, k4_err = compare_backward(k3, k4, plain3, pairs,
                                          prep.tiles_touched, what)
        del plain3
        rows = pair_rows(feat9, pairs.ids)
        mpt = int(pairs.tile_counts.max())
        plain3_ms = cuda_time_ms(lambda: composite_backward_plain(
            rows, pairs.tile_starts, pairs.tile_counts, dC, dT, W, H, cfg,
            mpt), 1, warm=False)
        plain4_ms = cuda_time_ms(lambda: segment_sum_plain(
            k3, pairs.offsets, prep.tiles_touched), 3)
        plain = composite_plain(
            rows, pairs.tile_starts, pairs.tile_counts, W, H, cfg, mpt,
            box_mask=pair_box_mask_plain(rows, pairs.tile_starts,
                                         pairs.tile_counts, W, H, cfg))
    log(f"K3 / K4 standalone ms: K3 {k3_ms:.4f} (plain {plain3_ms:.1f}), K4 "
        f"{k4_ms:.4f} (plain {plain4_ms:.1f}, index_add_ {lib4_ms:.4f})")
    log_k3_evaluations(what, plain)
    k2_err = compare_composite(color, final_T, plain.color, plain.final_T,
                               what)

    n_live = int(pairs.tile_counts.sum())
    N, P = feat9.shape[0], W * H
    k1_work = emission_work(N, cfg.pair_capacity, int(pairs.num_pairs))
    k2_work = forward_composite_work(n_live, gx * gy, N, P, plain)
    log_emission_bounds(what, *k1_work)
    log(f"{what}: K2 {ft['k2']:.4f} ms against a bound of "
        f"{bound(*k2_work)[0]:.4f} ms ({bound(*k2_work)[1]}), K1 "
        f"{ft['k1']:.4f} ms against {bound(*k1_work)[0]:.4f} ms "
        f"({bound(*k1_work)[1]})")
    k3_ops = compositor_ops(plain, K3_OPS_PER_ACCEPTED)
    k3_bytes = n_live * (4 + 8 + 36) + N * 36 + 8 * P * 4 + gx * gy * 8
    k4_bytes = int(pairs.num_pairs) * 36 + N * (8 + 4 + 36)
    log(f"K3 work: {n_live} live pairs, {int(plain.n_evaluated)} (pair, "
        f"pixel) evaluations of which {int(plain.n_accepted)} accepted, "
        f"{k3_ops} FP32 ops, {k3_bytes} bytes; K4 bytes {k4_bytes} over "
        f"{int(pairs.num_pairs)} slots (capacity {pairs.ids.shape[0]})")
    return dict(k3=(k3_ms, plain3_ms, None, k3_err, k3_bytes, k3_ops),
                k4=(k4_ms, plain4_ms, lib4_ms, k4_err, k4_bytes, 0),
                k1=dict(train_ms=ft["k1"], train_max_abs_err=k1_err,
                        train_bound_ms=bound(*k1_work)[0]),
                k2=dict(train_ms=ft["k2"], train_max_abs_err=k2_err,
                        train_bound_ms=bound(*k2_work)[0],
                        train_heaviest_tile_ms=ft["k2_heaviest_tile"]))


def phase_timings(r, launches):
    """K1 and K2 at the main path's shapes (view 0, left), each beside its
    plain version on the same inputs; then K3 and K4 on that render (the
    dense regime: a trained model's splats), held to reruns and K4 to its
    sums, with no plain backward at this density. Returns K1's and K2's
    rows of the kernels line and K3's and K4's dense numbers."""
    from gs2mesh_torch.core.camera import camera_from_euler
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_plain,
                                                   sort_pairs)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_plain, pair_box_mask_plain, pair_rows)

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

        what = "300k/960x576 dense render"
        prep = run_preprocess()
        feat9 = build_feat9(prep)
        eargs = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        em, pairs, color_k, T_k, ft = time_forward_kernels(eargs, what)
        save_forward_case(what, eargs, em, color_k, T_k)
        _, k1_err = compare_emission(em, emission_plain(*eargs), gx * gy,
                                     what)
        mpt = int(pairs.tile_counts.max())
        pargs = (pair_rows(feat9, pairs.ids), pairs.tile_starts,
                 pairs.tile_counts, W, H, cfg, mpt)
        plain = composite_plain(*pargs, box_mask=pair_box_mask_plain(
            pargs[0], pairs.tile_starts, pairs.tile_counts, W, H, cfg))
        k2_err = compare_composite(color_k, T_k, plain.color, plain.final_T,
                                   what)

        t = dict(
            preprocess=cuda_time_ms(run_preprocess, 20),
            k1=ft["k1"],
            k1_plain=cuda_time_ms(lambda: emission_plain(*eargs), 5),
            sort=cuda_time_ms(lambda: sort_pairs(em, gx * gy), 20),
            k2=ft["k2"], k2_heaviest_tile=ft["k2_heaviest_tile"],
            k2_plain=cuda_time_ms(lambda: composite_plain(*pargs), 2))
        k3, k4, k3_ms, k4_ms, lib4_ms = time_backward_kernels(
            pairs, feat9, prep.tiles_touched, color_k, T_k,
            *loss_cotangents(color_k, T_k), W, H, cfg, what)
        check_k4_sums(k3, k4, pairs, prep.tiles_touched, what)
        del k3, k4
    log("device ms per stage at 300k/960x576 (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log_k3_evaluations(what, plain)

    n_live = int(pairs.tile_counts.sum())
    n_eval = int(plain.n_evaluated)
    k1_bytes, k1_ops = emission_work(N, K, int(pairs.num_pairs))
    k2_bytes, k2_ops = forward_composite_work(n_live, gx * gy, N, W * H,
                                              plain)
    log(f"K2 work: {n_live} live pairs, {n_eval} (pair, pixel) evaluations "
        f"({n_eval / (W * H):.1f} per pixel), {int(plain.n_accepted)} "
        f"accepted, {k2_ops} FP32 ops, {k2_bytes} bytes")
    log_emission_bounds(what, k1_bytes, k1_ops)

    rows = []
    for name, src, replaces, key, err, (nb, nops) in (
            ("emit_pairs", "gs2mesh_torch/csrc/emit.cu",
             "gs2mesh_tpu/ops/rasterizer/emit.py:191", "emit", k1_err,
             (k1_bytes, k1_ops)),
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
    rows[1]["heaviest_tile_ms"] = t["k2_heaviest_tile"]
    dense = dict(
        k3=(k3_ms, None, n_live * (4 + 8 + 36) + N * 36 + 8 * W * H * 4
            + gx * gy * 8, compositor_ops(plain, K3_OPS_PER_ACCEPTED)),
        k4=(k4_ms, lib4_ms, int(pairs.num_pairs) * 36 + N * (8 + 4 + 36), 0))
    for key, (ms, _, nb, nops) in dense.items():
        log(f"{what}: {key.upper()} {ms:.4f} ms against a bound of "
            f"{bound(nb, nops)[0]:.4f} ms ({bound(nb, nops)[1]})")
    return rows, dense


OWN_KERNELS = {"K1": "emit_pairs_kernel", "K2": "composite_forward_kernel",
               "K3": "composite_backward", "K4": "segment_sum_kernel"}


def own_kernel_ms(prof, n):
    """Device ms per unit of each of the port's kernels over n profiled
    units, by kernel name (K3 with its fill kernel)."""
    from torch.autograd import DeviceType

    ms = dict.fromkeys(OWN_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            for kernel, part in OWN_KERNELS.items():
                if part in e.name:
                    ms[kernel] += e.time_range.elapsed_us() / n / 1e3
    return ms


def report_profile(prof, wall_us, n, unit):
    """Device-busy share of the wall time of n profiled units, and the
    kernels that take the device time. Only device-side activity
    (kernels, copies, fills) counts: an operator's row and a
    record_function range on the device track repeat the time of the
    kernels under them."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return None
    log(f"profile over {n} {unit}s: wall {wall_us / n / 1e3:.3f} ms/{unit}, "
        f"device busy {busy_us / n / 1e3:.3f} ms/{unit}, idle share "
        f"{1 - busy_us / wall_us:.3f}, "
        f"{sum(c for _, c in by_name.values()) // n} device events/{unit}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {t / n / 1e3:8.4f} ms/{unit} x{c // n:<4d} {name[:90]}")
    log(f"  the port's kernels, device ms/{unit}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in own_kernel_ms(prof, n).items()))
    return busy_us / n / 1e3


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
    report_profile(prof, wall_us, n, "render")


# Dense peaks of one H100 SXM (NVIDIA data sheet), for the stereo phase's
# achieved rate: FP32 outside the tensor cores, TF32 and bf16 tensor cores.
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
STEREO_SMALL = (128, 192)        # phase 5b's card-vs-CPU size (H, W)


def stereo_pair(h, w, seed=0, shift=4):
    """[LR, RL] batch of a smooth seeded texture and its copy shifted by
    ``shift`` pixels, in [0, 255] (tests/test_torch_stereo_cuda.py uses it
    too)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w + shift].astype(np.float64)
    img = np.zeros((h, w + shift, 3))
    for _ in range(16):
        f, ph = rng.uniform(0.03, 0.5, 2), rng.uniform(0, 6.3, 3)
        img += np.sin(f[0] * xx[..., None] + f[1] * yy[..., None] + ph)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).round()
    left = img[:, shift:].transpose(2, 0, 1)[None]
    right = img[:, :w].transpose(2, 0, 1)[None]
    return (torch.from_numpy(np.concatenate([left, right[..., ::-1]])
                             .astype(np.float32)),
            torch.from_numpy(np.concatenate([right, left[..., ::-1]])
                             .astype(np.float32)))


def phase_stereo_checks(model):
    """DLNR on the card against the CPU at 128x192, 2 iterations, cold and
    with a flow so negative that the refinement runs: float64 on both within
    1e-8 of the largest |disparity|; float32 (TF32 off) within 1e-4 of it, or
    4x the CPU's own float32 error against float64 where that is larger;
    then the bf16 policy against float32 on the card within 0.15 (the JAX
    test's limit)."""
    import copy

    from gs2mesh_torch.stereo import DLNRConfig, dlnr_forward
    from gs2mesh_torch.stereo.layers import matmul_dtype

    h, w = STEREO_SMALL
    cfg = DLNRConfig(iters=2)
    a, b = stereo_pair(h, w)
    models = {("cpu", torch.float32): copy.deepcopy(model).cpu(),
              ("cuda", torch.float32): model}
    models[("cpu", torch.float64)] = copy.deepcopy(
        models[("cpu", torch.float32)]).double()
    models[("cuda", torch.float64)] = copy.deepcopy(model).double()

    def run(dev, dtype, flow_init, policy=None):
        m = models[(dev, dtype)]
        cast = lambda x: None if x is None else x.to(dev, dtype)  # noqa
        with torch.inference_mode(), matmul_dtype(policy):
            _, disp = dlnr_forward(m, cast(a), cast(b), cfg, cast(flow_init))
        return disp.double().cpu(), m.last_refined

    for what, init in (("cold", None), ("flow_init -40", -40.0)):
        flow_init = None if init is None else torch.full(
            (2, 2, h // 4, w // 4), init)
        exact, ref_cpu = run("cpu", torch.float64, flow_init)
        card64, ref64 = run("cuda", torch.float64, flow_init)
        cpu32, _ = run("cpu", torch.float32, flow_init)
        card32, ref32 = run("cuda", torch.float32, flow_init)
        scale = float(exact.abs().max())
        e64 = float((card64 - exact).abs().max())
        cpu_err = float((cpu32 - exact).abs().max()) / scale
        limit = max(1e-4, 4 * cpu_err)
        e32 = float((card32 - cpu32).abs().max())
        e32x = float((card32 - exact).abs().max())
        log(f"stereo {what} {h}x{w}: refinement ran on cpu64 / card64 / "
            f"card32: {ref_cpu} / {ref64} / {ref32}; max |disp| {scale:.4f}; "
            f"card vs cpu float64 {e64:.3e} px ({e64 / scale:.3e} of max, "
            f"limit 1e-8); float32 card vs cpu {e32:.3e} px "
            f"({e32 / scale:.3e}), card vs float64 {e32x / scale:.3e}, cpu "
            f"vs float64 {cpu_err:.3e}: limit {limit:.3e}")
        check(ref_cpu is ref64 is ref32 is (init is not None),
              f"stereo {what}: refinement branch")
        check(e64 <= 1e-8 * scale, f"stereo {what}: float64 card vs cpu")
        check(e32 <= limit * scale and e32x <= limit * scale,
              f"stereo {what}: float32 card vs cpu")
    d32, _ = run("cuda", torch.float32, None)
    d16, _ = run("cuda", torch.float32, None, policy=torch.bfloat16)
    gap = float((d32 - d16).abs().max()) / float(d32.abs().max())
    log(f"stereo bf16 policy vs float32 on the card, {h}x{w} cold: max |d| / "
        f"max |disp| {gap:.4f} (limit 0.15)")
    check(bool(torch.isfinite(d16).all()) and gap < 0.15,
          "stereo bf16 policy vs float32")


def stereo_flops(model, h, w):
    """Convolution and matmul FLOPs of one [LR, RL] forward at h x w with
    10 iterations, counted by torch.utils.flop_counter from the operators'
    shapes as they run (no refinement: a cold forward does not refine)."""
    from torch.utils.flop_counter import FlopCounterMode

    from gs2mesh_torch.stereo import DLNRConfig, dlnr_forward

    a, b = (x.cuda() for x in stereo_pair(h, w))
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        dlnr_forward(model, a, b, DLNRConfig(iters=10))
    check(model.last_refined is False, "FLOP count forward did not refine")
    return fc.get_total_flops()


def stereo_ranges(prof, n):
    """Device ms per view of each stereo.* and dlnr.* record_function range
    (a kernel counts toward the range in which its launching operator
    started; the ranges do not nest), the rest as "outside"."""
    import bisect

    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.split(".")[0] in ("stereo", "dlnr"))
    starts = [r[0] for r in ranges]
    dev = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        name = ranges[i][2] if i >= 0 and e.time_range.start < ranges[i][1] \
            else "outside"
        for k in e.kernels:
            dev[name] = dev.get(name, 0.0) + k.duration / n / 1e3
    host = {}
    for a, b, name in ranges:
        host[name] = host.get(name, 0.0) + (b - a) / n / 1e3
    return dev, host


def run_stereo_stage(stage, r, policy, what):
    """One Stereo.run() over the serving views under the matmul policy:
    per-view wall ms (host clock), DLNR forward device ms (CUDA events),
    the refinement branch and warm start of each forward, K1 / K2 launches
    and peak device memory."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda
    from gs2mesh_torch.stereo.layers import matmul_dtype

    marks, fwd = [], []
    plain_render, plain_forward = r.render_image_pair, stage._forward

    def render_pair(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return plain_render(i)

    def forward(b1, b2, flow_init):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_forward(b1, b2, flow_init)
        end.record()
        fwd.append((start, end, stage.model.last_refined,
                    flow_init is not None))
        return out

    r.render_image_pair, stage._forward = render_pair, forward
    emission_cuda.launches = composite_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with matmul_dtype(policy):
            stage.run()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    finally:
        r.render_image_pair, stage._forward = plain_render, plain_forward
    launches = {"K1": emission_cuda.launches, "K2": composite_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    walls = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    fwd_ms = [s.elapsed_time(e) for s, e, _, _ in fwd]
    for i, (wall, ms, (_, _, refined, warm)) in enumerate(zip(walls, fwd_ms,
                                                              fwd)):
        log(f"stereo {what} view {i}: wall {wall:.2f} ms, DLNR forward "
            f"{ms:.2f} device ms, warm start {warm}, refinement ran "
            f"{refined}")
    log(f"stereo {what}: launches over {len(walls)} views {launches}; peak "
        f"device memory {peak / 2 ** 30:.3f} GiB")
    check(len(walls) == len(r) and len(fwd) == len(r), f"stereo {what}: "
          f"one forward per view")
    check([w_ for *_, w_ in fwd] == [False] + [True] * (len(r) - 1),
          f"stereo {what}: warm start from the second view on")
    check(launches["K1"] == launches["K2"] == 2 * len(r),
          f"stereo {what}: K1 / K2 twice a view: {launches}")
    return walls, fwd_ms, launches, peak


def check_stereo_artifacts(r, model_name, what):
    """Every view's artifact set with the reference's dtypes and shapes and
    a finite disparity. Returns the LR disparities."""
    from gs2mesh_torch.core.png import read_png

    c = r.cameras[0]["left"]
    hw = (c["height"], c["width"])
    disps = []
    for i in range(len(r)):
        out = os.path.join(r.render_folder_name(i), f"out_{model_name}")
        for name, dtype in (("disparity_LR", np.float32),
                            ("disparity_RL", np.float32),
                            ("occlusion_mask", np.bool_),
                            ("depth", np.float32)):
            a = np.load(os.path.join(out, f"{name}.npy"))
            check(a.dtype == dtype and a.shape == hw,
                  f"stereo {what} view {i} {name}.npy: {a.dtype} {a.shape}")
            if name.startswith("disparity"):
                check(bool(np.isfinite(a).all()),
                      f"stereo {what} view {i} {name}: finite")
        for name, shape in (("disparity_LR", hw + (3,)),
                            ("disparity_RL", hw + (3,)),
                            ("occlusion_mask", hw + (3,)), ("depth", hw),
                            ("shading", hw)):
            check(read_png(os.path.join(out, f"{name}.png")).shape == shape,
                  f"stereo {what} view {i} {name}.png shape")
        disps.append(np.load(os.path.join(out, "disparity_LR.npy")))
    return disps


def phase_stereo(r):
    """The stereo stage on the serving phase's renderer: the seeded DLNR
    held to the CPU (phase_stereo_checks), then Stereo.run() over the 4
    views at 960x576, 10 iterations, warm start on, in float32 (TF32 off)
    and in the bf16 policy; then both again under torch.profiler for the
    range breakdown and the device idle share, and the forward's FLOPs.
    Returns K1's and K2's launches over the float32 run."""
    from torch.profiler import ProfilerActivity, profile

    from gs2mesh_torch.pipeline import PipelineArgs, Stereo
    from gs2mesh_torch.pipeline.stereo_stage import STAGE_RANGES
    from gs2mesh_torch.stereo import DLNR, init_dlnr_
    from gs2mesh_torch.stereo.dlnr import FORWARD_STAGES
    from gs2mesh_torch.stereo.layers import matmul_dtype

    model = init_dlnr_(DLNR(), torch.Generator().manual_seed(0)).eval()
    model = model.cuda()
    t0 = time.perf_counter()
    phase_stereo_checks(model)
    log(f"stereo checks: {time.perf_counter() - t0:.1f} s")

    c = r.cameras[0]["left"]
    h, w = c["height"], c["width"]
    args = PipelineArgs.for_dataset("DTU", colmap_name="smoke")
    check(args.stereo_warm, "DTU warm-starts")
    stage = Stereo(r.output_dir_root, r, args, model=model, device="cuda")
    flops = stereo_flops(model, h, w)
    log(f"stereo forward at {w}x{h}, [LR, RL], 10 iterations: "
        f"{flops / 1e12:.4f} TFLOP of convolutions and matmuls "
        f"(torch.utils.flop_counter)")
    results = {}
    for what, policy in (("float32", None), ("bf16", torch.bfloat16)):
        with matmul_dtype(policy):        # warm-up: the last view alone
            stage.run(start=len(r) - 1)
        walls, fwd_ms, launches, peak = run_stereo_stage(stage, r, policy,
                                                         what)
        disps = check_stereo_artifacts(r, args.stereo_model, what)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with matmul_dtype(policy):
                stage.run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = report_profile(prof, wall_us, len(r), "view")
        dev, host = stereo_ranges(prof, len(r))
        order = ([f"stereo.{k}" for k in STAGE_RANGES[:2]]
                 + [f"dlnr.{k}" for k in FORWARD_STAGES]
                 + [f"stereo.{k}" for k in STAGE_RANGES[2:]] + ["outside"])
        log(f"stereo {what} ranges, device ms / host ms per view: "
            + ", ".join(f"{k} {dev.get(k, 0.0):.3f} / {host.get(k, 0.0):.3f}"
                        for k in order))
        med = float(np.median(fwd_ms[1:]))
        peak_key = "bf16" if policy is not None else "fp32"
        log(f"stereo {what}: view wall median {np.median(walls):.2f} ms, "
            f"DLNR forward median (warm views) {med:.2f} device ms: "
            f"{flops / med / 1e9:.2f} TFLOP/s achieved, "
            f"{100 * flops / med / 1e-3 / PEAK_OPS_PER_S[peak_key]:.2f}% of "
            f"the {peak_key} peak; bounds at fp32 / tf32 / bf16 peaks "
            + " / ".join(f"{flops / v * 1e3:.3f}"
                         for v in PEAK_OPS_PER_S.values()) + " ms")
        results[what] = dict(walls=walls, fwd_ms=fwd_ms, launches=launches,
                             peak=peak, busy=busy, disps=disps)
    gap = max(float(np.abs(a - b).max()) / float(np.abs(a).max())
              for a, b in zip(results["float32"]["disps"],
                              results["bf16"]["disps"]))
    log(f"stereo stage bf16 vs float32 disparity_LR: max |d| / max |disp| "
        f"{gap:.4f} over {len(r)} views (reported, not checked: warm starts "
        f"chain the views)")
    return results["float32"]["launches"]



def main():
    global SAVE_FORWARD_DIR
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save-forward", metavar="DIR")
    ap.add_argument("--replay-forward", metavar="DIR")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "one CUDA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain compositor bmm
    torch.backends.cudnn.allow_tf32 = False
    SAVE_FORWARD_DIR = opts.save_forward
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
    if opts.replay_forward:
        replay_forward(opts.replay_forward)
        return
    from gs2mesh_torch.ops.rasterizer.composite import kernel_info
    from gs2mesh_torch.ops.rasterizer.emit import emission_kernel_info
    for name, info in (("K1", emission_kernel_info()),
                       ("K2", kernel_info("K2")), ("K3", kernel_info("K3"))):
        log(f"{name}: {info['registers']} registers a thread, "
            f"{info['shared_bytes']} B static shared memory, "
            f"{info['blocks_per_sm']} blocks per SM (occupancy API)")

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    phase_backward_vs_plain(*phase_kernels_vs_plain(
        "20k/256x256", 20_000, 256, 256, (0.04, 0.012), 100))
    phase_backward_vs_plain(*phase_kernels_vs_plain(
        "60k narrow/360x200", 60_000, 360, 200, (0.006, 0.002), 10))
    log(f"phase kernels-vs-plain: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    r, renders, launches = phase_main_path(work)
    log(f"phase main path: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows, dense = phase_timings(r, launches)
    phase_profile(r)
    log(f"phase timings + profile: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    stereo = phase_stereo(r)
    for row, key in zip(rows, ("K1", "K2")):
        row["launches_stereo"] = stereo[key]
    del r
    log(f"phase stereo: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    trainer, step_wall_ms, train_launches = phase_train(work)
    log(f"phase train: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    train_t = phase_train_timings(trainer, step_wall_ms)
    rows += backward_rows(train_t, dense, train_launches)
    for row, key in zip(rows, ("K1", "K2")):
        row["launches_train"] = train_launches[key]
        row.update(train_t[key.lower()])
    log(f"phase train timings + profile: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(work)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
