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
     K3's sub-box mask and K3's empty-pair branches do the work; on both
     scenes P1 (preprocess) bit-equal to preprocess_plain on every output
     that decides a pair (rgb within 1e-6) and P2 (its backward) at the
     scene's loss cotangent against preprocess_backward_plain and against
     autograd of the plain forward (phase_preprocess_vs_plain), each
     bit-identical across two runs;
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
 5c. TSDF fusion (plain PyTorch on the card; no Pallas kernel on this
     path): (1) tests/test_fusion.py's sphere (20 views at 128x128, voxel
     0.02, trunc 0.06, capacity 4096) fused on the card and on the CPU:
     keys, order and n_blocks equal, weight equal and tsdf and colour within
     1e-5 on >= 99.99% of the live voxels (the count off and the largest gap
     printed), mesh face counts within 0.1%, >= 99.9% of the card's
     vertices within 1e-4 voxel of a CPU vertex; (2) tools/bench_tsdf.py's
     DTU-scale scene (tools/bench_tsdf_torch.py::dtu_sphere_views: 50
     views of a 0.5 sphere at 960x576,
     voxel 2/512, trunc 0.04, capacity 1 << 14): allocate and integrate
     device ms a view (median of views 2-50), host wall, blocks (no
     overflow), integrate's byte bound, block-sparse extraction s and
     device ms, vertices, faces, peak memory; the 98% quantile of
     | |v| - 0.5 | under 2 voxels, outward normals on > 99%; (3) the TSDF
     stage on the 4 served views with DTU flags and FullMasker masks (close
     + erode on): on the random DLNR's depth (blocks, vertices), then on
     the unit sphere's analytic depth inside a printed baseline band: run,
     save_mesh, clean_mesh, both PLYs read back, > 1000 cleaned vertices
     with median | |v| - 1 | under 2 voxels; again under torch.profiler for
     each tsdf.* range's device and host ms a view and the idle share;
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
  8. the pipeline (run_single and the DTU driver) on a DTU-layout scan at
     DTU's resolution: 8 views of the 300k SH-3 sphere rendered by the port
     at 1554x1162 (the crop dtu_mask_loader makes of DTU's 1600x1200
     masks) with a text COLMAP model holding the 300k centres, 1600x1200
     silhouette masks, cameras.npz with the sphere at 80 mm, ObsMask /
     Plane .mat files and 1M stl points on the sphere. Pass 1:
     run_single(PipelineArgs.for_dataset("DTU"), stereo_model=<seeded
     DLNR>, device="cuda"): 40 GS steps from from_point_cloud, the 8
     stereo pairs, Stereo.run() at 10 iterations in float32, the DTU masks,
     the TSDF stage; K1-K4 launches as the path implies (40 + 16, 40),
     every artifact at create_strings' paths, view 0's left.png closer to
     its target than 0.9x the untrained model's L1. Pass 2: the sphere's
     analytic depth over each view, then
     run_pipeline.main(["dtu", "--scans", "24", "--skip_GS",
     "--skip_rendering", ...]) from the scan's base directory (masks, TSDF,
     cull_scan, dtu_eval, the CSV row): > 1000 cleaned vertices with median
     | |v| - 1 | under 2 voxels, d2s, s2d and overall finite and under 2
     voxels in mm, results.json and the vis_*.ply files. Both passes under
     torch.profiler: host seconds and device busy by run_single.* /
     run_DTU.* / dtu_eval.* range, pass 1's peak memory. The kernels line
     gets each kernel's launches over pass 1 (launches_pipeline);
  9. SAM2 masking (plain PyTorch on the card; no Pallas kernel on it):
     (a) a seeded SAM2Config.tiny(128) with the object gate opened, on the
     card against the CPU: the image predictor's IoUs and low-res logits and
     3-frame video propagation, float64 within 1e-9 of the largest |value|,
     float32 (TF32 off) within 1e-4 of it or 4x the CPU's own float32 error
     against float64; (b) a seeded SAM2Config.large() written as
     sam2_hiera_large.pt (the released layout), SAM2Masker(device="cuda")
     .segment() over phase 8's 8 pass-1 views at 1554x1162 (image size
     1024): per-frame encode and track ms, peak memory, every
     left_mask.{npy,png} with the view's shape, the mask fill;
 10. the GS tools: gs_full_eval on phase 6's scene (8 views at 960x576,
     300k points, view 0 held out) for 40 iterations with checkpoints at 20
     and 40, each stage's wall, K1-K4 launches as the run implies
     (launches_gs_tools in the kernels line), the test renders' shapes and
     finite metrics; gs_metrics(lpips=True) on seeded VGG16 / LPIPS head
     files; LPIPS on the card against the CPU on one 960x576 pair (2e-4
     relative) and its ms; render_golden on the card against K1/K2 on a
     3000-gaussian 64x64 scene (2e-5);
 11. GroundingDINO and the interactive masker (plain PyTorch on the card;
     no Pallas kernel on it): (a) a seeded small model (Swin embed 32,
     BERT 64 wide, 20 queries, 2 + 2 layers) on the golden test's 64x96
     input, card against CPU at phase 9a's limits (float64 within 1e-9 of
     the largest finite |value|; float32 within 1e-4 of it or 4x the CPU's
     own float32 error against float64), -inf positions equal, the top-k
     indices equal across devices in both dtypes, the outputs decoded from
     the CPU float64 run's picks; (b) a seeded SwinT-OGC (GDINOConfig(), 172M
     weights) written as groundingdino_swint_ogc.pth in the released
     layout beside a synthetic 30,522-line vocab.txt;
     SAM2Masker(gdino_checkpoint=..., gdino_vocab=..., sam2_checkpoint=
     <9b's sam2_hiera_large.pt>, box_threshold=0).segment() over phase 8's
     8 views at 1554x1162: one finite view-0 box, its centre in the image
     and its extent within the image's, that seeds SAM2, every
     left_mask.{npy,png}; predict's ms cold and the median of 3 warm,
     the forward's device ms (CUDA events) and by gdino.* range (torch.profiler, every range busy), its FLOPs and
     TFLOP/s, peak memory above what was resident before (segment(), and
     a predict's working memory); view 0 at full width on the card
     against the CPU at (a)'s limits, in both dtypes: the float64 top-k
     equal, then every run decodes the CPU float64 run's picks so each
     output is held (how many float32 picks order apart is printed);
     (c) run_interactive_masker on view 0 with stub
     matplotlib modules playing 5 scripted clicks and drags: 5 redraws
     through preview_mask (SAM2-large, ms each), the seeds reaching
     segment(), every mask;
 12. the strided tile-row mode (the multi-rank step's slices): (a) every
     slice of G = 2, 4, 8 of phase 3's 60k narrow scene, K1 bit-exact, K2,
     K3 and K4 at phase 3's limits against their plain versions; (b) on
     phase 4's serving view, K1 and K2 slice by slice, the stitched colour
     and final_T bit-equal to the unsharded K2 render, the slices' pairs
     summing to the unsharded count (balance printed), K3 + K4 per slice
     summed over the slices within phase 3's K3 limits of the unsharded
     gradient, each kernel's ms per slice beside per-slice bounds;
 13. ShardedTrainer on a (1 x 1) mesh over NCCL (a world of one from a file
     store under smoke_out/), phase 6's 25 steps on phase 6's scene beside
     Trainer: first-step params within 5e-5, every loss within 1e-4
     relative, the alive count around the densify equal, K1-K4 once per
     step, both step walls;
 14. make_sharded_dlnr on two served stereo pairs at 960x576 (10
     iterations) and make_sharded_integrate on phase 5c's 20-view sphere,
     against the unsharded calls (1e-5; bit-equal);
 15. ViewerServer(device="cuda") on phase 4's PLY at 960x540: /, /info and
     20 /render at seeded orbit poses, each PNG byte-equal to the quantised
     K1/K2 render of its camera, K1 / K2 once per request; ms a request,
     the render's device ms and the PNG encode ms;
 16. gs_train(gui=True) on phase 10's scene for 10 iterations with a
     scripted SIBR client asking for 960x576 frames (byte counts, verify
     string), once more without a client; the final model's frame equal
     to a direct render; ms a frame and the step with and without the
     client;
 17. profile_trace around 3 renders (the Chrome trace names K1 and K2),
     time_block on a render, view_results_panel on view 0's stereo outputs;
 19. (after 17) sustained training and the custom-data walkthrough: (a)
     tools/trainsmoke_chip_torch.py's run(): 1,200 iterations on 6
     golden targets at 480x288 of a 4000-gaussian sphere from a 500-row
     init, its checks (finite params, the MA-50 loss under half the first,
     alive > 500) and its dict (by 200-iteration window the median step
     wall and the device busy ms of 10 profiled steps, densifies, growth,
     launches, peak memory); K1-K4 once per taken step (K1 / K2 also per
     redone one); (b) on (a)'s scene 120 iterations that force
     both growths (a 1,000-row capacity, densify every 20 from 20 to 100
     at a 1e-9 threshold, a pair capacity of half the first render's
     pairs): grow_capacity and the overflow redo fire, finite loss and
     params, launches as implied; (c) tools/calibrate_scene_torch.py's
     run() at full width (24 ring views of the 300k bench sphere at
     960x576, a 30k-row init, capacity 2^19, pair capacity 2^22), cut from
     4,000 to 1,500 iterations (6 densifies) to fit the smoke: the loss
     falls, alive rows grow, finite params, no taken step over the pair
     capacity, launches as implied. After (a), (b) and (c) (so after the
     last densify and growth) one step of K1-K4 on the trainer's live
     state (params and alive mask at the grown capacity, dead rows
     included, its pair capacity, view 0, the training loss's cotangent)
     against emission_plain, composite_plain, composite_backward_plain and
     the plain segment sum at phase 3's limits; (d) the walkthrough
     examples/custom_data_walkthrough_torch.py cell by cell on a
     custom-layout copy of phase 6's scene (the text model run_colmap
     leaves), video and COLMAP skipped, GS_iterations=40, a seeded DLNR
     at checkpoints/<stereo_model>.pth, masking off, the 3 plotting calls
     left out (printed): each cell's wall, the panel (H, W, 3) uint8, K1-K4
     launches as the path implies (40 steps and their redos, 4 PSNR views,
     the overlap cell's pair, 2 a stereo view), the cleaned mesh written;
     then the sphere's analytic depth and the TSDF cell again: > 1000
     cleaned vertices within 2 voxels of the sphere;
 20. (after 19) the reference's schedule at scale: (a) 19c's trainer
     carried past its first opacity reset (the reset at 3,000, then
     iterations 3,001-3,100 with the densify at 3,100, the size prune on):
     that densify removes exactly the opacity and world-size candidates
     and no row for its screen size (the rows over 20 px that the JAX
     package's rule would remove are > 0 and printed, and kept), alive
     after >= alive before - (opacity + world-size candidates), K1-K4 once
     per step; (b) tools/train_scale_torch.py's dense scene at full size
     (1M ground-truth splats on a textured sphere and ground plane, 64
     training and 8 held-out views at 960x576 rendered by the port, PNGs
     and a binary COLMAP model with 50,000 points), the GS stage's own
     trainer on it (pipeline.run_single.gs_trainer), the schedule's
     iterations 201-500 (the first densify at 500) by 100-iteration
     window, then one step's K1-K4 against their plain versions on that
     state at phase 3's limits (as for 19 a-c);
 21. (after 20) the benchmark cells (bench_cells/): the training cell's
     300k SH-3 model at 960x576 on the card, its step-0 K1-K4 against
     their plain versions at the cell's pair capacity and loss cotangent
     (phase 3's limits), the plain emission's pair count and the plain
     compositor's accepted count equal to the committed ones
     (bench_cells/counts.py); one step of the cell's own step function
     through K1-K4, once each, with the committed pair count and the
     reference's step-0 loss (bench_cells/reference.py, the cell's limit);
     one view of the stereo cell (seeded DLNR, 960x576, 10 iterations)
     with the committed refinement gate and within the cell's limit of
     the float64 reference's disparity; P1 and P2 as in phase 3 on the
     cell's model at its loss cotangent, timed beside their plain
     versions and their bounds;
     on every path that counts K1-K4 launches, P1 must launch with every
     K1 (once a render) and P2 with every K3 (once a step);
 18. the card's name and power limit again, the "kernels" JSON line (P1
     and P2 after K1-K4, timed on the training cell's model; K1-K3
     with their strided ms and bounds per G; every kernel with its
     launches on the viewer, GUI, sharded, trainsmoke, calibrate,
     walkthrough, size-prune, dense-scene and bench-cell paths and its max
     abs error against the plain version on the trained states of 19 a-c
     and 20 b and on the training cell's model of 21),
     and the last line: {"ok": true, "device": {...}}.
Scratch files go to smoke_out/ beside this script and are removed at the end.
"""

import dataclasses
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


def path_wrappers():
    """The wrappers a path's launches are read from: K1-K4 and P1 / P2."""
    from gs2mesh_torch.ops.rasterizer import (kernel_wrappers,
                                              preprocess_kernel_wrappers)

    return {**kernel_wrappers(), **preprocess_kernel_wrappers()}


PREP_LAUNCHES = {}             # path -> P1's and P2's launches on it


def read_launches(counters, path=None, p1_outside=0):
    """K1-K4's launches since ``counters`` (path_wrappers()) were zeroed.
    P1 must have launched with every K1 (once a render) and P2 with every
    K3 (once a taken step): every render preprocesses once, and every
    backward through K3 goes on through P2. p1_outside counts the path's
    preprocess calls outside a render (render_golden's targets, a tool's
    statistics), which launch P1 and no K1. P1's and P2's counts are kept
    in PREP_LAUNCHES[path] for the kernels line."""
    launches = {k: c.launches for k, c in counters.items()}
    check(launches["P1"] == launches["K1"] + p1_outside
          and launches["P2"] == launches["K3"],
          f"P1 / P2 launched as K1 (+ {p1_outside}) / K3: {launches}")
    if path is not None:
        PREP_LAUNCHES[path] = {k: launches[k] for k in ("P1", "P2")}
    return {k: v for k, v in launches.items() if k.startswith("K")}


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


def compare_emission(em_k, em_p, num_tiles, what, key_tiles=None):
    from gs2mesh_torch.ops.rasterizer.emit import sort_pairs

    check(int(em_k.num_pairs) == int(em_p.num_pairs), f"{what}: num_pairs")
    check(torch.equal(em_k.keys, em_p.keys), f"{what}: K1 keys")
    check(torch.equal(em_k.ids, em_p.ids), f"{what}: K1 ids")
    sk, sp = (sort_pairs(em_k, num_tiles, key_tiles),
              sort_pairs(em_p, num_tiles, key_tiles))
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
    """K1 and K2 against their plain versions on a seeded sphere scene,
    then P1 and P2 (phase_preprocess_vs_plain)."""
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
    phase_preprocess_vs_plain(
        what, inp, cam, 3, cfg,
        lambda color, T: (color ** 2).mean() + 0.1 * T.mean())
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


# P1 / P2, FP32 operations per gaussian at SH degree 3, counted from
# csrc/preprocess.cu (the projection and EWA terms, which P2 recomputes,
# ~330; the radius, rect and colour of P1 ~190; P2's chain rule ~450 and
# its SH basis, derivatives and sums ~320). At any degree the byte bound
# is over ten times the operation bound.
P1_OPS_PER_GAUSSIAN = 520
P2_OPS_PER_GAUSSIAN = 1100
PREP_FIELDS = ("means2d", "depths", "conic", "rgb", "radius", "rect",
               "tiles_touched")


def preprocess_work(n, K):
    """P1's and P2's bytes (each input read once, each output written once:
    P1 reads means, scales, rotation, opacity and the SH row and writes 15
    values; P2 reads the same but the opacity, and the 8 cotangents, and
    writes the 10 parameter gradients and the SH row's) and operations."""
    p1 = n * 4 * ((3 + 3 + 4 + 1 + 3 * K) + (2 + 1 + 3 + 3 + 1 + 4 + 1))
    p2 = n * 4 * ((3 + 3 + 4 + 3 * K + 2 + 3 + 3) + (3 + 3 + 4 + 3 * K))
    return ((p1, n * P1_OPS_PER_GAUSSIAN), (p2, n * P2_OPS_PER_GAUSSIAN))


def fused_inputs(inp):
    """A render's activated inputs as P1 and P2 take them."""
    n = inp["means3d"].shape[0]
    return tuple(x.float().contiguous() for x in (
        inp["means3d"], inp["scales"], inp["rotations"],
        inp["opacities"].reshape(n), inp["shs"]))


def preprocess_cotangents(inp, cam, sh_degree, cfg, loss_fn):
    """The cotangents of means2d, conic and rgb that a training step's
    backward (K3 + K4) hands the preprocess: feat9's gradient under
    loss_fn(color, final_T)."""
    from gs2mesh_torch.ops.rasterizer.composite import composite
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9, emit_pairs,
                                                   sort_pairs)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess

    W, H = cam.width, cam.height
    gx, gy = cfg.grid_size(W, H)
    with torch.no_grad():
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam, sh_degree, cfg)
        feat9 = build_feat9(prep)
        pairs = sort_pairs(emit_pairs(feat9, prep.depths, prep.rect,
                                      prep.tiles_touched, W, H, cfg), gx * gy)
    check(not bool(pairs.overflow), "pair overflow")
    feat9.requires_grad_(True)
    color, final_T, _ = composite(feat9, pairs, prep.tiles_touched, W, H, cfg)
    loss_fn(color, final_T).backward()
    g = feat9.grad
    return (g[:, 0:2].contiguous(), g[:, 2:5].contiguous(),
            g[:, 6:9].contiguous())


def compare_grads(got, ref, what, rel, col, worst):
    """Gradients against a reference, K3's form: a value is within
    tolerance if within ``rel`` of itself plus ``col`` of its column's
    largest magnitude; >= 99.99% must be, and none more than ``worst`` of
    its column's largest magnitude apart. Returns the max abs error."""
    errs = []
    for name, a, b in zip(("means3d", "scales", "rotations", "shs"), got,
                          ref):
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        scale = b.abs().amax(0)
        gap = (a - b).abs()
        ok = gap <= rel * b.abs() + col * scale
        share = float(ok.float().mean())
        worst_gap = float((gap / scale.clamp_min(1e-30)).max())
        finite = bool(torch.isfinite(a).all())
        log(f"{what} {name}: {gap.numel()} values, {100 * share:.5f}% "
            f"within tolerance, max abs err {float(gap.max()):.3e} (largest "
            f"gap / column max {worst_gap:.3e})")
        check(finite, f"{what} {name}: finite")
        check(share >= 0.9999, f"{what} {name}: {share:.6f} < 0.9999")
        check(worst_gap <= worst, f"{what} {name}: gap {worst_gap:.3e}")
        errs.append(float(gap.max()))
    return max(errs)


def phase_preprocess_vs_plain(what, inp, cam, sh_degree, cfg, loss_fn,
                              timed=False):
    """P1 and P2 against their plain versions on a render's activated
    inputs: P1's pair-deciding outputs (all but rgb) bit-equal to
    preprocess_plain's, rgb within 1e-6; P2 at the render's loss cotangent
    against preprocess_backward_plain (1e-5 relative + 1e-6 of the column
    max, every value within 1e-4 of it) and against autograd of
    preprocess_plain (1e-4 + 1e-5, every value within 1e-3: autograd sums
    each gradient in its own order and float32 cancels in the covariance's
    chain); each bit-identical across two runs. With timed=True also the
    ms of both and of their plain versions, and the bounds. Returns the
    max abs errors (and the times)."""
    from gs2mesh_torch.ops.rasterizer.preprocess import (
        preprocess_backward_cuda, preprocess_backward_plain,
        preprocess_forward_cuda, preprocess_plain)

    x = fused_inputs(inp)
    n, K = x[0].shape[0], x[4].shape[1]
    fwd = (*x, cam, sh_degree, cfg, 1.0)
    with torch.no_grad():
        k1, k2 = preprocess_forward_cuda(*fwd), preprocess_forward_cuda(*fwd)
        plain = preprocess_plain(*x, cam, sh_degree, cfg)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"{what}: P1 bit-identical across two runs")
    for name, a in zip(PREP_FIELDS, k1):
        if name != "rgb":
            check(torch.equal(a, getattr(plain, name)),
                  f"{what}: P1 {name} bit-equal to the plain version")
    p1_err = float((k1[3] - plain.rgb).abs().max())
    check(p1_err <= 1e-6, f"{what}: P1 rgb max abs err {p1_err:.3e}")
    log(f"{what}: P1 == plain bit for bit on means2d, depths, conic, radius, "
        f"rect, tiles_touched ({n} gaussians, {int((k1[4] > 0).sum())} on "
        f"screen, {int(k1[6].sum())} tiles touched), rgb max abs err "
        f"{p1_err:.3e}; bit-identical across two runs")

    cot = preprocess_cotangents(inp, cam, sh_degree, cfg, loss_fn)
    bwd = (x[0], x[1], x[2], x[4], cam, sh_degree, cfg, 1.0, *cot)
    with torch.no_grad():
        g1, g2 = preprocess_backward_cuda(*bwd), preprocess_backward_cuda(*bwd)
        gp = preprocess_backward_plain(*bwd)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
          f"{what}: P2 bit-identical across two runs")
    p2_err = compare_grads(g1, gp, f"{what}: P2 vs plain", 1e-5, 1e-6, 1e-4)
    leaves = [t.clone().requires_grad_(True) for t in x]
    out = preprocess_plain(*leaves, cam, sh_degree, cfg)
    ga = torch.autograd.grad((out.means2d, out.conic, out.rgb),
                             [leaves[i] for i in (0, 1, 2, 4)], cot)
    compare_grads(g1, ga, f"{what}: P2 vs autograd", 1e-4, 1e-5, 1e-3)
    del leaves, out, ga
    res = dict(P1=p1_err, P2=p2_err)
    if not timed:
        return res
    with torch.no_grad():
        ms = dict(
            P1=cuda_time_ms(lambda: preprocess_forward_cuda(*fwd), 50,
                            queued=True),
            P2=cuda_time_ms(lambda: preprocess_backward_cuda(*bwd), 50,
                            queued=True),
            P1_plain=cuda_time_ms(
                lambda: preprocess_plain(*x, cam, sh_degree, cfg), 10),
            P2_plain=cuda_time_ms(lambda: preprocess_backward_plain(*bwd),
                                  10))
    work = preprocess_work(n, K)
    rows = []
    for key, name, (nbytes, nops), err in (
            ("P1", "preprocess_forward", work[0], p1_err),
            ("P2", "preprocess_backward", work[1], p2_err)):
        bms, by = bound(nbytes, nops)
        log(f"{what}: {key} {ms[key]:.4f} ms (plain {ms[key + '_plain']:.4f}),"
            f" bound {bms:.4f} ms ({by}: {nbytes} bytes, {nops} FP32 ops), "
            f"{bms / ms[key]:.3f} of it")
        rows.append({"name": name, "route": "cuda",
                     "source": "gs2mesh_torch/csrc/preprocess.cu",
                     "replaces": "gs2mesh_tpu/ops/rasterizer/preprocess.py:94 "
                                 "(jnp under jit, no pallas_call)",
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[key + "_plain"], "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
    return res, rows


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
    from gs2mesh_torch.ops.rasterizer.preprocess import \
        preprocess_forward_cuda
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
    preprocess_forward_cuda.launches = 0
    images = [r.render_image_pair(i) for i in range(n_views)]
    launches = {"emit": emission_cuda.launches,
                "composite": composite_cuda.launches,
                "preprocess": preprocess_forward_cuda.launches}
    r.render_single = plain_render

    for k, rec in enumerate(renders):
        log(f"render {k} ({'left' if k % 2 == 0 else 'right'} of view "
            f"{k // 2}): {rec['ms']:.3f} ms, num_pairs {rec['num_pairs']}, "
            f"overflow {rec['overflow']}, launches so far K1 {rec['k1']} "
            f"K2 {rec['k2']}")
    log(f"main path launches: K1 {launches['emit']}, K2 "
        f"{launches['composite']}, P1 {launches['preprocess']} over "
        f"{len(renders)} renders")
    check(len(renders) == 2 * n_views, "8 renders")
    check(launches["emit"] == launches["composite"]
          == launches["preprocess"] == len(renders),
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
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    trainer.train(20, callback=record)
    trainer.reset_opacity()
    trainer.train(5, callback=record)
    torch.cuda.synchronize()
    launches = read_launches(counters, "train")

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
    return rows, dense, dict(eargs=eargs, plain=plain)


OWN_KERNELS = {"K1": "emit_pairs_kernel", "K2": "composite_forward_kernel",
               "K3": "composite_backward", "K4": "segment_sum_kernel",
               "P1": "preprocess_forward_kernel",
               "P2": "preprocess_backward_kernel"}


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


def range_times(prof, n, prefixes):
    """Device ms per unit of each record_function range whose name starts
    with one of ``prefixes`` + "." (a kernel counts toward the range in
    which its launching operator started; the ranges do not nest), the rest
    as "outside"; and each range's host ms per unit."""
    import bisect

    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.split(".")[0] in prefixes)
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
    the refinement branch and warm start of each forward, K1 / K2 / P1
    launches and peak device memory."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda
    from gs2mesh_torch.ops.rasterizer.preprocess import \
        preprocess_forward_cuda
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
    preprocess_forward_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with matmul_dtype(policy):
            stage.run()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    finally:
        r.render_image_pair, stage._forward = plain_render, plain_forward
    launches = {"K1": emission_cuda.launches, "K2": composite_cuda.launches,
                "P1": preprocess_forward_cuda.launches}
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
    check(launches["K1"] == launches["K2"] == launches["P1"] == 2 * len(r),
          f"stereo {what}: K1 / K2 / P1 twice a view: {launches}")
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
        dev, host = range_times(prof, len(r), ("stereo", "dlnr"))
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



# ---------------------------------------------------------------- phase 5c
# The reference's TPU run of its bench scene (BENCH_TSDF.json): counts of
# the scene, printed beside the port's; its times are the TPU's.
REFERENCE_DTU_COUNTS = {"blocks": 14877, "vertices": 905918}


def look_at_extrinsic(eye):
    """(4, 4) float32 world->camera looking at the origin, +z forward, +y
    down, z up (tests/test_fusion.py's cameras)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=0)
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ eye
    return E.astype(np.float32)


def sphere_depth(K, E, width, height, radius=1.0):
    """Analytic projective depth of a sphere at the origin seen through K
    and world->camera E at integer pixel coordinates (0 where no hit); the
    depth tests/test_fusion.py fuses."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)],
                 axis=-1)
    c = E[:3, 3].astype(np.float64)                  # sphere centre in cam
    b = -2.0 * (d * c).sum(-1)
    a = (d * d).sum(-1)
    disc = b * b - 4 * a * ((c * c).sum() - radius ** 2)
    tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    return np.where((disc > 0) & (tt > 0), tt * d[..., 2], 0.0).astype(
        np.float32)


def small_sphere_views():
    """tests/test_fusion.py's fused_sphere: 20 views at 128x128."""
    W = H = 128
    K = np.array([[120.0, 0, (W - 1) / 2.0], [0, 120.0, (H - 1) / 2.0],
                  [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    for i in range(20):
        th = 2 * np.pi * i / 20
        E = look_at_extrinsic((2.6 * np.cos(th), 2.6 * np.sin(th),
                               0.8 * np.sin(3 * th + rng.uniform(0, 0.2))))
        depth = sphere_depth(K, E, W, H)
        color = np.zeros((H, W, 3), np.float32)
        color[..., 0] = np.clip(depth / 4.0, 0, 1)
        color[..., 1] = 0.5
        yield color, depth, K, E


def fuse(views, cfg, device, depth_trunc, timing=None):
    """The stage's per-view loop on ``device``: allocate (doubling the
    capacity and redoing the allocation on overflow), then integrate. With
    ``timing`` (a list), each view's CUDA events and host wall go into it."""
    from gs2mesh_torch import fusion

    vol = fusion.create_volume(cfg, device)
    for color, depth, K, E in views:
        color, depth, K, E = (torch.as_tensor(a).to(device)
                              for a in (color, depth, K, E))
        if timing is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
        fresh = fusion.allocate(vol, depth, K, E, depth_trunc, cfg)
        while fresh.overflow:
            vol, cfg = fusion.grow_volume(vol, cfg)
            fresh = fusion.allocate(vol, depth, K, E, depth_trunc, cfg)
        if timing is not None:
            ev[1].record()
        vol = fusion.integrate(fresh, color, depth, K, E, depth_trunc, cfg)
        if timing is not None:
            ev[2].record()
            torch.cuda.synchronize()
            timing.append((ev, (time.perf_counter() - t0) * 1e3,
                           vol.n_blocks, depth.shape))
    return vol, cfg


def phase_tsdf_card_vs_cpu():
    """tests/test_fusion.py's sphere (20 views at 128x128, voxel 0.02, trunc
    0.06, capacity 4096, stride 2) fused on the card and on the CPU. Limits:
    keys, order and n_blocks equal; weight equal on >= 99.99% of the live
    voxels, tsdf and colour within 1e-5 there; the meshes' face counts
    within 0.1%, and >= 99.9% of the card's vertices within 1e-4 voxel of a
    CPU vertex."""
    from scipy.spatial import cKDTree

    from gs2mesh_torch import fusion

    cfg = fusion.TSDFConfig(voxel_size=0.02, sdf_trunc=0.06, block_size=8,
                            block_capacity=4096, alloc_stride=2)
    views = list(small_sphere_views())
    card, _ = fuse(views, cfg, "cuda", 4.0)
    cpu, _ = fuse(views, cfg, "cpu", 4.0)
    n = cpu.n_blocks
    check(card.n_blocks == n and not card.overflow, "tsdf card vs cpu: "
          f"n_blocks {card.n_blocks} vs {n}")
    check(torch.equal(card.keys.cpu(), cpu.keys)
          and torch.equal(card.order.cpu(), cpu.order),
          "tsdf card vs cpu: keys / order")
    live = n * cfg.block_size ** 3
    w_off = int((card.weight[:n].cpu() != cpu.weight[:n]).sum())
    gaps = {k: (getattr(card, k)[:n].cpu() - getattr(cpu, k)[:n]).abs()
            for k in ("tsdf", "color")}
    t_off = int((gaps["tsdf"] > 1e-5).sum())
    c_off = int((gaps["color"].amax(-1) > 1e-5).sum())
    log(f"tsdf card vs cpu, 20 views 128x128: {n} blocks, {live} live "
        f"voxels; weight differs on {w_off}, tsdf beyond 1e-5 on {t_off} "
        f"(max gap {float(gaps['tsdf'].max()):.3e}), colour on {c_off} "
        f"(max gap {float(gaps['color'].max()):.3e}); limit 1e-4 of the "
        f"live voxels each")
    for what, off in (("weight", w_off), ("tsdf", t_off), ("colour", c_off)):
        check(off <= 1e-4 * live, f"tsdf card vs cpu: {what}")
    mc = fusion.extract_triangle_mesh(card, cfg)
    mp = fusion.extract_triangle_mesh(cpu, cfg)
    dist, _ = cKDTree(mp.vertices).query(mc.vertices)
    near = float((dist <= 1e-4 * cfg.voxel_size).mean())
    same = np.array_equal(mc.faces, mp.faces) and \
        np.array_equal(mc.vertices, mp.vertices)
    ngap = float(np.abs(mc.vertex_normals - mp.vertex_normals).max()) \
        if same else float("nan")
    log(f"tsdf card vs cpu meshes: faces {len(mc.faces)} / {len(mp.faces)}, "
        f"vertices {len(mc.vertices)} / {len(mp.vertices)}, "
        f"{100 * near:.4f}% of card vertices within 1e-4 voxel of a CPU "
        f"vertex (limit 99.9%), faces and vertices bit-equal: {same}, "
        f"normals max gap {ngap:.3e}")
    check(abs(len(mc.faces) - len(mp.faces)) <= 1e-3 * len(mp.faces)
          and len(mp.faces) > 2000, "tsdf card vs cpu: face counts")
    check(near >= 0.999, "tsdf card vs cpu: vertices")


def phase_tsdf_dtu():
    """tools/bench_tsdf.py's DTU-scale scene on the card: 50 views at
    960x576, voxel 2/512, trunc 0.04, origin (-1, -1, -1), depth_trunc 3,
    capacity 1 << 14. Per-view allocate / integrate device ms (CUDA events,
    median over views 2-50) and host wall, integrate's byte bound, the
    block-sparse extraction, peak memory; checks the 98% quantile of
    | |v| - 0.5 | under 2 voxels and outward normals on > 99% of
    vertices."""
    from gs2mesh_torch import fusion

    cfg = fusion.TSDFConfig(voxel_size=2.0 / 512, sdf_trunc=0.04,
                            block_capacity=1 << 14, origin=(-1.0, -1.0, -1.0))
    t0 = time.perf_counter()
    views = [tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                   for a in v) for v in load_script(
                       "tools", "bench_tsdf_torch").dtu_sphere_views()]
    log(f"tsdf DTU scene: 50 views built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing = []
    vol, cfg = fuse(views, cfg, "cuda", 3.0, timing)
    alloc_ms = [ev[0].elapsed_time(ev[1]) for ev, *_ in timing]
    integ_ms = [ev[1].elapsed_time(ev[2]) for ev, *_ in timing]
    walls = [w for _, w, _, _ in timing]
    med = {k: float(np.median(v[1:])) for k, v in (
        ("allocate", alloc_ms), ("integrate", integ_ms), ("wall", walls))}
    H, W = timing[-1][3]
    live = vol.n_blocks * cfg.block_size ** 3
    nbytes = live * 40 + H * W * 16
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    check(not vol.overflow and cfg.block_capacity == 1 << 14,
          f"tsdf DTU: no overflow ({cfg.block_capacity})")
    log(f"tsdf DTU fusion, 50 views 960x576: {vol.n_blocks} blocks "
        f"(the reference's count {REFERENCE_DTU_COUNTS['blocks']}); median "
        f"over views 2-50: allocate {med['allocate']:.3f} device ms, "
        f"integrate {med['integrate']:.3f} device ms, host wall "
        f"{med['wall']:.3f} ms a view (ranges allocate "
        f"{min(alloc_ms[1:]):.3f}-{max(alloc_ms[1:]):.3f}, integrate "
        f"{min(integ_ms[1:]):.3f}-{max(integ_ms[1:]):.3f}, wall "
        f"{min(walls[1:]):.3f}-{max(walls[1:]):.3f}); first view allocate "
        f"{alloc_ms[0]:.3f} integrate {integ_ms[0]:.3f} wall "
        f"{walls[0]:.3f}")
    log(f"tsdf DTU integrate bytes a view at the last view: {live} live "
        f"voxels x 40 B (tsdf, weight, colour read and written) + {H}x{W} "
        f"x 16 B image = {nbytes} B; bound {bound_ms:.4f} ms at 3.35 TB/s "
        f"against {integ_ms[-1]:.3f} ms measured there")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    mesh = fusion.extract_triangle_mesh(vol, cfg)
    end.record()
    torch.cuda.synchronize()
    ext_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    r = np.linalg.norm(mesh.vertices, axis=1)
    q98 = float(np.quantile(np.abs(r - 0.5), 0.98))
    outward = float(((mesh.vertex_normals * mesh.vertices).sum(1) > 0).mean())
    log(f"tsdf DTU extraction (block-sparse): {ext_s:.3f} s wall, "
        f"{start.elapsed_time(end):.3f} device ms (CUDA events, device to "
        f"host copy included); {len(mesh.vertices)} vertices (the "
        f"reference's count {REFERENCE_DTU_COUNTS['vertices']}), "
        f"{len(mesh.faces)} faces; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; 98% quantile of ||v| - 0.5| "
        f"{q98:.3e} (limit {2 * cfg.voxel_size:.3e}), outward normals "
        f"{100 * outward:.3f}% (limit 99%)")
    check(q98 < 2 * cfg.voxel_size, "tsdf DTU: mesh on the sphere")
    check(outward > 0.99, "tsdf DTU: outward normals")


def phase_tsdf_stage(r, model_name):
    """The TSDF stage on the 4 served views phase_stereo left: DTU flags,
    FullMasker masks (TSDF_erode_mask on). First on the random-weight
    DLNR's depth (blocks, vertices, finished), then on the unit sphere's
    analytic depth with an all-ones occlusion mask: run, save_mesh,
    clean_mesh, both PLYs read back, > 1000 cleaned vertices with median
    | |v| - 1 | under 2 voxels; then again under torch.profiler for each
    tsdf.* range's device and host ms a view and the idle share."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from gs2mesh_torch.core.ply import read_ply
    from gs2mesh_torch.pipeline import TSDF, FullMasker, PipelineArgs
    from gs2mesh_torch.pipeline.tsdf_stage import STAGE_RANGES

    stereo = types.SimpleNamespace(model_name=model_name)
    FullMasker(r).segment()
    args = PipelineArgs.for_dataset("DTU", colmap_name="smoke")
    check(args.TSDF_use_mask and args.TSDF_erode_mask, "DTU masks, eroded")
    n = len(r)

    def run(stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    stage = TSDF(r, stereo, args, "smoke_dlnr", device="cuda")
    wall = run(stage)
    log(f"tsdf stage on the random-weight DLNR depth ({n} views, DTU "
        f"flags): finished in {wall:.1f} ms, {stage.volume.n_blocks} blocks "
        f"(capacity {stage.cfg.block_capacity}), "
        f"{len(stage.mesh.vertices)} vertices")

    b = r.baseline
    args.TSDF_min_depth_baselines = int(1.5 / b)
    args.TSDF_max_depth_baselines = int(math.ceil(4.0 / b))
    band = (args.TSDF_min_depth_baselines * b,
            args.TSDF_max_depth_baselines * b / args.TSDF_scale)
    for i, cam in enumerate(r.left_cameras):
        K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                      [0, 0, 1.0]])
        E = np.linalg.inv(np.asarray(cam["extrinsic"], np.float64))
        depth = sphere_depth(K, E, cam["width"], cam["height"])
        hit = depth[depth > 0]
        check(band[0] < hit.min() and hit.max() < band[1],
              f"tsdf stage view {i}: sphere depth {hit.min():.3f}-"
              f"{hit.max():.3f} inside the band {band}")
        out = os.path.join(r.render_folder_name(i), f"out_{model_name}")
        np.save(os.path.join(out, "depth.npy"), depth)
        np.save(os.path.join(out, "occlusion_mask.npy"),
                np.ones(depth.shape, bool))
    log(f"tsdf stage, analytic unit-sphere depth: baseline {b:.5f}, band "
        f"[{args.TSDF_min_depth_baselines} x b, "
        f"{args.TSDF_max_depth_baselines} x b] = [{band[0]:.4f}, "
        f"{band[1]:.4f}]")
    stage = TSDF(r, stereo, args, "smoke", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    wall = run(stage)
    paths = (stage.save_mesh(), stage.clean_mesh())
    for path, mesh in zip(paths, (stage.mesh, stage.cleaned)):
        d = read_ply(path)
        check(np.array_equal(d.positions, mesh.vertices)
              and np.array_equal(d.faces, mesh.faces),
              f"tsdf stage: {os.path.basename(path)} reads back")
    voxel = args.TSDF_voxel / 512.0
    rad = np.linalg.norm(stage.cleaned.vertices, axis=1)
    med = float(np.median(np.abs(rad - 1.0)))
    log(f"tsdf stage: run {wall:.1f} ms for {n} views, "
        f"{stage.volume.n_blocks} blocks (capacity "
        f"{stage.cfg.block_capacity}), mesh "
        f"{len(stage.mesh.vertices)} vertices / {len(stage.mesh.faces)} "
        f"faces, cleaned {len(stage.cleaned.vertices)} / "
        f"{len(stage.cleaned.faces)}; median ||v| - 1| {med:.3e} (limit "
        f"{2 * voxel:.3e}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    check(len(stage.cleaned.vertices) > 1000, "tsdf stage: cleaned mesh")
    check(med < 2 * voxel, "tsdf stage: cleaned mesh on the sphere")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage.run()
        stage.save_mesh()
        stage.clean_mesh()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, n, "view")
    dev, host = range_times(prof, n, ("tsdf",))
    log("tsdf stage ranges, device ms / host ms a view: " + ", ".join(
        f"{k} {dev.get(k, 0.0):.3f} / {host.get(k, 0.0):.3f}"
        for k in [f"tsdf.{k}" for k in STAGE_RANGES] + ["outside"]))


def phase_tsdf(r, model_name):
    """Phase 5c: fusion card vs CPU, the DTU-scale scene, the TSDF stage."""
    for what, fn in (("card vs cpu", phase_tsdf_card_vs_cpu),
                     ("DTU scale", phase_tsdf_dtu),
                     ("stage", lambda: phase_tsdf_stage(r, model_name))):
        t0 = time.perf_counter()
        fn()
        log(f"tsdf {what}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 8
# The whole pipeline on a DTU-layout scan at DTU's resolution: 1554x1162 is
# the crop dtu_mask_loader makes of DTU's 1600x1200 masks (its principal
# point DTU_PP). The target renders of the 300k SH-3 sphere need ~11M pairs.
PIPE = dict(n=300_000, width=1554, height=1162, views=8, iters=40, scan=24,
            r_mm=80.0, stl_points=1_000_000, obs_res_mm=2.0,
            target_capacity=1 << 24)
PIPE_C_MM = np.array([-3.0, 7.0, 560.0])   # the sphere's centre, world mm
# The trained model's left.png of view 0 must be closer to its target (mean
# |difference| of the 8-bit images) than this share of the untrained
# model's render (from_point_cloud's splats, 6x smaller than the target's).
PIPE_L1_SHARE = 0.9
DTU_PP = (823.204, 619.071)


def dtu_crop(length, centre):
    """[a, b) of dtu_mask_loader's crop of one mask axis."""
    half = min(length - centre, centre)
    return int(centre - half), int(centre + half)


def dtu_mask_size(width, height):
    """The mask size whose DTU crop is width x height, and the crop's
    origin: (1600, 1200) and (46, 38) for 1554x1162."""
    def axis(n, centre):
        for m in range(1, 4096):
            a, b = dtu_crop(m, centre)
            if b - a == n:
                return m, a
        raise ValueError(f"no DTU mask size crops to {n}")

    (mw, x0), (mh, y0) = axis(width, DTU_PP[0]), axis(height, DTU_PP[1])
    return (mw, mh), (x0, y0)


def pipeline_eyes(n):
    """n cameras at distance 3 towards the cube's corners (every point of
    the unit sphere within 55 degrees of a camera's axis)."""
    corners = [np.array([sx, sy, sz], np.float64)
               for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]
    return [3.0 * c / np.linalg.norm(c) for c in corners[:n]]


def write_dtu_scan(base, cfg):
    """data/DTU/scan<N>/ (8 target PNGs rendered by the port, a text COLMAP
    model with the 300k centres as points3D, 1600x1200 silhouette masks,
    cameras.npz with the sphere at r_mm mm) and data/DTU/SampleSet/MVS_Data
    (ObsMask / Plane .mat files, the stl points on the sphere in mm)."""
    import scipy.io

    from gs2mesh_torch.core import colmap_io
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.core.ply import write_ply
    from gs2mesh_torch.core.png import write_png
    from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize

    W, H, n_views, scan = cfg["width"], cfg["height"], cfg["views"], \
        cfg["scan"]
    fx = W / (2 * math.tan(math.radians(30)))
    (mw, mh), (x0, y0) = dtu_mask_size(W, H)
    k_full = np.array([[fx, 0, x0 + W / 2], [0, fx, y0 + H / 2], [0, 0, 1]])
    scan_dir = os.path.join(base, "data", "DTU", f"scan{scan}")
    sparse = os.path.join(scan_dir, "sparse", "0")
    for sub in ("images", "mask"):
        os.makedirs(os.path.join(scan_dir, sub))
    d = sphere_scene(cfg["n"], seed=0)
    cams = {1: colmap_io.ColmapCamera(
        id=1, model="PINHOLE", width=W, height=H,
        params=np.array([fx, fx, W / 2, H / 2]))}
    images, mats = {}, {}
    scale_mat = np.diag([cfg["r_mm"]] * 3 + [1.0])
    scale_mat[:3, 3] = PIPE_C_MM
    target = GaussianModel(params_from_numpy(d), 3).raster_inputs()
    rcfg = RasterizerConfig(pair_capacity=cfg["target_capacity"])
    pairs = []
    for i, eye in enumerate(pipeline_eyes(n_views)):
        R, t = look_at(eye)
        images[i + 1] = colmap_io.ColmapImage(
            id=i + 1, qvec=rotmat2qvec_wxyz(R), tvec=t, camera_id=1,
            name=f"{i:03}.png", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64))
        with torch.no_grad():
            out = rasterize(target["means3d"], target["scales"],
                            target["rotations"], target["opacities"],
                            target["shs"],
                            make_camera(R.T, t, 2 * math.atan(W / (2 * fx)),
                                        2 * math.atan(H / (2 * fx)), W, H),
                            3, cfg=rcfg)
        check(not bool(out.overflow), "target render overflow")
        pairs.append(int(out.num_pairs))
        img = (out.image.clamp(0, 1) * 255).round().to(torch.uint8)
        write_png(os.path.join(scan_dir, "images", f"{i:03}.png"),
                  img.permute(1, 2, 0).cpu().numpy())
        E = np.eye(4)
        E[:3, :3], E[:3, 3] = R, t
        sil = sphere_depth(k_full, E, mw, mh) > 0
        write_png(os.path.join(scan_dir, "mask", f"{i:03}.png"),
                  sil.astype(np.uint8) * 255)
        w2c_mm = np.eye(4)
        w2c_mm[:3, :3] = R
        w2c_mm[:3, 3] = cfg["r_mm"] * t - R @ PIPE_C_MM
        k4 = np.eye(4)
        k4[:3, :3] = k_full
        mats[f"world_mat_{i}"] = k4 @ w2c_mm
        mats[f"scale_mat_{i}"] = scale_mat
    del target
    colmap_io.write_model_text(sparse, cams, images, bench_points(d))
    np.savez(os.path.join(scan_dir, "cameras.npz"), **mats)

    mvs = os.path.join(base, "data", "DTU", "SampleSet", "MVS_Data")
    os.makedirs(os.path.join(mvs, "ObsMask"))
    res = cfg["obs_res_mm"]
    lo = PIPE_C_MM - cfg["r_mm"] - 10.0
    side = int(math.ceil(2 * (cfg["r_mm"] + 10.0) / res)) + 1
    scipy.io.savemat(os.path.join(mvs, "ObsMask", f"ObsMask{scan}_10.mat"),
                     {"ObsMask": np.ones((side,) * 3, np.uint8),
                      "BB": np.stack([lo, lo + (side - 1) * res]),
                      "Res": np.array([[res]])})
    scipy.io.savemat(os.path.join(mvs, "ObsMask", f"Plane{scan}.mat"),
                     {"P": np.array([[0.0], [0.0], [0.0], [1.0]])})
    m = cfg["stl_points"]
    k = np.arange(m) + 0.5
    phi = np.arccos(1 - 2 * k / m)
    theta = math.pi * (1 + 5 ** 0.5) * k
    stl = cfg["r_mm"] * np.stack([np.cos(theta) * np.sin(phi),
                                  np.sin(theta) * np.sin(phi), np.cos(phi)],
                                 -1) + PIPE_C_MM
    write_ply(os.path.join(mvs, "Points", "stl", f"stl{scan:03}_total.ply"),
              {a: stl[:, j].astype(np.float32) for j, a in enumerate("xyz")})
    log(f"pipeline scan: {n_views} views at {W}x{H} (fx {fx:.1f}), masks "
        f"{mw}x{mh} cropped at ({x0}, {y0}), {cfg['n']} points3D; target "
        f"renders {min(pairs)}-{max(pairs)} pairs (pair_capacity "
        f"{cfg['target_capacity']}); sphere radius {cfg['r_mm']} mm (DTU's "
        f"objects ~200-300 mm), {m} stl points, ObsMask {side}^3 at {res} mm")
    return d, fx


def init_model_l1(d, fx, cfg, target_png):
    """Mean |difference| between view 0's target and the render of the
    model from_point_cloud makes of the scan's points3D (the untrained
    model train_gs starts from)."""
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.core.sh import C0
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig
    from gs2mesh_torch.train.trainer import render_model

    W, H = cfg["width"], cfg["height"]
    rgb = np.clip((d["features_dc"][:, 0] * C0 + 0.5) * 255.0, 0, 255)
    model = GaussianModel.from_point_cloud(
        d["xyz"], rgb.round().astype(np.uint8) / 255.0, device="cuda")
    R, t = look_at(pipeline_eyes(cfg["views"])[0])
    cam = make_camera(R.T, t, 2 * math.atan(W / (2 * fx)),
                      2 * math.atan(H / (2 * fx)), W, H)
    with torch.no_grad():
        out = render_model(model.params, model.alive, cam, 0,
                           torch.zeros(3, device="cuda"), RasterizerConfig())
    img = (out.image.clamp(0, 1) * 255).round().to(torch.uint8)
    img = img.permute(1, 2, 0).cpu().numpy().astype(np.float64)
    return float(np.abs(img - read_png(target_png)).mean() / 255.0)


def stage_report(prof, wall_s, groups, what):
    """Host seconds, device-busy seconds and idle share of each
    record_function range of a pass, from its profile; groups are
    (prefix, range names) in the order they run."""
    log(f"{what}: wall {wall_s:.3f} s (profiled); host s / device busy s "
        f"/ idle share by range:")
    for prefix, names in groups:
        dev, host = range_times(prof, 1, (prefix,))
        for name in (f"{prefix}.{k}" for k in names):
            if name in host:
                h, b = host[name] / 1e3, dev.get(name, 0.0) / 1e3
                log(f"  {name:28s} {h:9.3f} / {b:8.4f} / {1 - b / h:.3f}")


def phase_pipeline(work, cfg=None):
    """Phase 8: run_single on a DTU-layout scan (pass 1: GS training ->
    stereo pairs -> DLNR -> DTU masks -> TSDF), then the DTU driver through
    the CLI on the sphere's analytic depth (pass 2: masks -> TSDF ->
    cull_scan -> dtu_eval -> CSV row). Returns K1-K4's launches over pass
    1's run_single, and pass 1's (base, colmap_dir, output root, args) for
    phase 9b."""
    import csv

    from torch.profiler import ProfilerActivity, profile

    from gs2mesh_torch.cli import run_pipeline
    from gs2mesh_torch.cli.drivers import DTU_RANGES
    from gs2mesh_torch.evals.dtu import EVAL_RANGES
    from gs2mesh_torch.core.ply import read_ply
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.pipeline import PipelineArgs, Renderer, create_strings
    from gs2mesh_torch.pipeline import run_single as rs
    from gs2mesh_torch.stereo import DLNR, init_dlnr_

    cfg = dict(PIPE, **(cfg or {}))
    base = os.path.join(work, "pipeline")
    stages = []                       # each pass's TSDF stage, for its counts

    class RecordedTSDF(rs.TSDF):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stages.append(self)

    def tsdf_counts():
        st = stages[-1]
        return (f"{st.volume.n_blocks} blocks (capacity "
                f"{st.cfg.block_capacity}), mesh {len(st.mesh.vertices)} "
                f"vertices, cleaned {len(st.cleaned.vertices)}")

    t0 = time.perf_counter()
    d, fx = write_dtu_scan(base, cfg)
    scan, iters, n_views = cfg["scan"], cfg["iters"], cfg["views"]
    name = f"scan{scan}"
    colmap_dir = os.path.join(base, "data", "DTU", name)
    l1_init = init_model_l1(d, fx, cfg, os.path.join(colmap_dir, "images",
                                                     "000.png"))
    del d
    log(f"pipeline set-up: {time.perf_counter() - t0:.1f} s")

    # ---- pass 1: the full pipeline through run_single
    args = PipelineArgs.for_dataset("DTU", colmap_name=name,
                                    GS_iterations=iters,
                                    GS_save_test_iterations=[iters])
    strings = create_strings(args, base)
    dlnr = init_dlnr_(DLNR(), torch.Generator().manual_seed(0))
    counters = path_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    rs.TSDF = RecordedTSDF
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mesh_path = rs.run_single(args, base_dir=base,
                                      stereo_model=dlnr, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rs.TSDF = RecordedTSDF.__base__
    launches = read_launches(counters, "pipeline")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    stage_report(prof, wall, [("run_single", rs.RUN_STAGES)],
                 "pipeline pass 1")
    del prof
    log(f"pipeline pass 1: profile read in {time.perf_counter() - t0:.1f} s;"
        f" peak device memory {peak:.3f} GiB")
    want = {"K1": iters + 2 * n_views, "K2": iters + 2 * n_views,
            "K3": iters, "K4": iters}
    log(f"pipeline pass 1 launches {launches} (implied by {iters} steps and "
        f"{n_views} stereo views, 2 renders each: {want}); equal counts "
        f"mean no step was redone, so no pair overflow in training, and a "
        f"stereo render raises on overflow")
    check(launches == want, f"pass 1 launches {launches} != {want}")

    check(mesh_path == strings["ply_path"], "cleaned mesh at create_strings'"
          f" ply_path ({mesh_path})")
    model_dir = os.path.join(base, "splatting_output", strings["splatting"],
                             name)
    out_root = strings["output_dir_root"]
    paths = [os.path.join(model_dir, "point_cloud", f"iteration_{iters}",
                          "point_cloud.ply"),
             os.path.join(model_dir, f"chkpnt{iters}.pt"),
             os.path.join(out_root, "camera_data.json"),
             os.path.join(out_root, f"{strings['TSDF']}_mesh.ply"), mesh_path]
    for i in range(n_views):
        view = os.path.join(out_root, f"{i:03}")
        paths += [os.path.join(view, f) for f in
                  ("left.png", "right.png", "left_mask.npy", "left_mask.png")]
        paths += [os.path.join(view, f"out_{args.stereo_model}", f) for f in
                  ("disparity_LR.npy", "disparity_RL.npy", "depth.npy",
                   "occlusion_mask.npy")]
    missing = [p for p in paths if not os.path.exists(p)]
    check(not missing, f"pass 1 artifacts missing: {missing[:4]}")
    mask0 = np.load(os.path.join(out_root, "000", "left_mask.npy"))
    check(mask0.shape == (cfg["height"], cfg["width"]) and mask0.any(),
          f"DTU mask of view 0: {mask0.shape}")
    target = read_png(os.path.join(colmap_dir, "images", "000.png"))
    left = read_png(os.path.join(out_root, "000", "left.png"))
    l1 = float(np.abs(left.astype(np.float64) - target).mean() / 255.0)
    l1_black = float(target.mean() / 255.0)
    log(f"pipeline pass 1: view 0 left.png vs its target: L1 {l1:.5f} "
        f"(untrained model {l1_init:.5f}, black image {l1_black:.5f}; limit "
        f"{PIPE_L1_SHARE} x untrained = {PIPE_L1_SHARE * l1_init:.5f})")
    check(l1 < PIPE_L1_SHARE * l1_init, "trained model closer to the target")
    log(f"pipeline pass 1 TSDF on the random-weight DLNR's depth: "
        f"{tsdf_counts()}")

    # ---- pass 2: analytic depth, then the DTU driver through the CLI
    r = Renderer(base, colmap_dir, out_root, args, device="cuda")
    b = r.baseline
    band = (args.TSDF_min_depth_baselines * b,
            args.TSDF_max_depth_baselines * b / args.TSDF_scale)
    for i, cam in enumerate(r.left_cameras):
        K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                      [0, 0, 1.0]])
        E = np.linalg.inv(np.asarray(cam["extrinsic"], np.float64))
        depth = sphere_depth(K, E, cam["width"], cam["height"])
        hit = depth[depth > 0]
        check(band[0] < hit.min() and hit.max() < band[1],
              f"view {i}: sphere depth inside the DTU band {band}")
        out = os.path.join(r.render_folder_name(i), f"out_{args.stereo_model}")
        np.save(os.path.join(out, "depth.npy"), depth)
        np.save(os.path.join(out, "occlusion_mask.npy"),
                np.ones(depth.shape, bool))
    del r
    argv = ["dtu", "--scans", str(scan), "--skip_GS", "--skip_rendering",
            "--GS_iterations", str(iters), "--GS_save_test_iterations",
            str(iters)]
    for k in counters.values():
        k.launches = 0
    cwd = os.getcwd()
    os.chdir(base)
    rs.TSDF = RecordedTSDF
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rc = run_pipeline.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        rs.TSDF = RecordedTSDF.__base__
    check(rc == 0, f"run_pipeline.main exit {rc}")
    check(all(c.launches == 0 for c in counters.values()),
          "pass 2 renders nothing")
    stage_report(prof, wall, [("run_single", rs.RUN_STAGES),
                              ("run_DTU", DTU_RANGES),
                              ("dtu_eval", EVAL_RANGES)],
                 f"pipeline pass 2 (python -m gs2mesh_torch.cli.run_pipeline "
                 f"{' '.join(argv)})")
    del prof
    voxel = args.TSDF_voxel / 512.0
    mesh = read_ply(mesh_path)
    rad = np.linalg.norm(mesh.positions, axis=1)
    med = float(np.median(np.abs(rad - 1.0)))
    log(f"pipeline pass 2 TSDF on the analytic depth: {tsdf_counts()}; "
        f"cleaned mesh {len(mesh.positions)} vertices, {len(mesh.faces)} "
        f"faces; median ||v| - 1| {med:.3e} (limit {2 * voxel:.3e})")
    check(len(mesh.positions) > 1000 and med < 2 * voxel,
          "pass 2: cleaned mesh on the sphere")
    exp = os.path.join(base, "evaluation", "DTU", "eval_output",
                       strings["dataset"])
    with open(os.path.join(exp, "evaluation_results.csv")) as f:
        rows = list(csv.reader(f))
    limit_mm = 2 * voxel * cfg["r_mm"]
    log(f"pipeline pass 2 CSV: {rows} (limit {limit_mm:.4f} mm = 2 voxels)")
    check(len(rows) == 2 and rows[1][0] == str(scan), "one CSV row")
    vals = [float(x) for x in rows[1][1:]]
    check(all(math.isfinite(v) and 0 <= v < limit_mm for v in vals),
          "d2s, s2d and overall finite and under 2 voxels in mm")
    for f in ("results.json", f"vis_{scan:03}_d2s.ply",
              f"vis_{scan:03}_s2d.ply", f"{strings['dataset']}_{name}.ply"):
        check(os.path.exists(os.path.join(exp, str(scan), f)), f"pass 2: {f}")
    return launches, (base, colmap_dir, out_root, args)


SAM2_SMALL = 128                 # phase 9a's card-vs-CPU image size
# Phase 9a's limits, against the largest |value| of the CPU's output: float64
# on the card against float64 on the CPU; float32 (TF32 off) against the
# CPU's float32, or 4x the CPU's own float32 error against float64 where
# that is larger (the anchoring phase 5b uses for DLNR).
SAM2_F64_TOL = 1e-9
SAM2_F32_TOL = 1e-4
# Phase 10's limit on LPIPS card against CPU, relative (tests/test_lpips.py).
LPIPS_PAIR_TOL = 2e-4


def sam2_frames(n, h=96, w=120, seed=0):
    """Seeded frames with a moving red square (tests/test_sam2.py)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        f[20 + 3 * i:60 + 3 * i, 30 + 3 * i:70 + 3 * i] = [200, 40, 40]
        out.append(f)
    return out


def sam2_seeded(cfg, seed=0):
    """The port's seeded SAM2 with the object gate opened (the object-score
    head's last bias at 5, tests/test_golden_fixtures.py:95-98), so the
    masks are the decoder's and not the no-object fill."""
    from gs2mesh_torch.sam2 import SAM2, init_sam2_params, load_weights

    state = init_sam2_params(cfg, seed)
    state["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(5.0)
    return state, load_weights(SAM2(cfg), state).eval()


def phase_sam2_checks():
    """Phase 9a: the image predictor (IoUs, low-res logits) and 3-frame
    video propagation at SAM2Config.tiny(128) on the card against the CPU,
    in float64 and then float32."""
    import copy

    from gs2mesh_torch.sam2 import (SAM2Config, SAM2ImagePredictor,
                                    SAM2VideoPredictor)

    _, net = sam2_seeded(SAM2Config.tiny(SAM2_SMALL))
    frames = sam2_frames(3)

    def run(dev, dtype):
        m = copy.deepcopy(net).to(dtype)
        img = SAM2ImagePredictor(m, device=dev)
        img.set_image(frames[0])
        _, ious, low = img.predict(point_coords=np.array([[60.0, 48.0]]),
                                   point_labels=np.array([1]))
        vid = SAM2VideoPredictor(m, device=dev)
        state = vid.init_state(frames=frames)
        vid.add_new_points_or_box(state, 0, box=[30, 20, 70, 60])
        video = np.stack([v for _, _, v in vid.propagate_in_video(state)])
        return {"ious": ious, "low-res logits": low, "video logits": video}

    compare_card_cpu({(d, t): {k: np.asarray(v) for k, v in
                               run(d, t).items()}
                      for d in ("cpu", "cuda")
                      for t in (torch.float64, torch.float32)},
                     f"sam2 tiny/{SAM2_SMALL}")


def compare_card_cpu(outs, what):
    """Hold the card's outputs to the CPU's at phase 9a's limits:
    ``outs[(device, dtype)]`` maps names to arrays; each is compared over
    the CPU float64 output's finite entries, relative to their largest
    magnitude, and its non-finite entries must be the same everywhere."""
    cpu64, card64 = outs[("cpu", torch.float64)], outs[("cuda", torch.float64)]
    cpu32, card32 = outs[("cpu", torch.float32)], outs[("cuda", torch.float32)]
    for key in cpu64:
        exact = cpu64[key].astype(np.float64)
        fin = np.isfinite(exact)
        for name, arr in (("card float64", card64[key]),
                          ("cpu float32", cpu32[key]),
                          ("card float32", card32[key])):
            check(np.array_equal(np.isfinite(arr), fin) and np.array_equal(
                arr[~fin], exact[~fin]), f"{what} {key}: {name} finite "
                f"where the cpu's float64 is")
        scale = float(np.abs(exact[fin]).max())
        gap = lambda a, b: float(np.abs(a[fin] - b[fin]).max()) / scale
        e64 = gap(card64[key], exact)
        check(e64 <= SAM2_F64_TOL, f"{what} {key}: float64 card vs cpu")
        cpu_err = gap(cpu32[key], exact)
        limit = max(SAM2_F32_TOL, 4 * cpu_err)
        e32, e32x = gap(card32[key], cpu32[key]), gap(card32[key], exact)
        log(f"{what} {key} {exact.shape}: max |value| "
            f"{scale:.4f}; card vs cpu float64 {e64:.3e} of max (limit "
            f"{SAM2_F64_TOL:.0e}); float32 card vs cpu {e32:.3e}, card vs "
            f"float64 {e32x:.3e}, cpu vs float64 {cpu_err:.3e}: limit "
            f"{limit:.3e}")
        check(e32 <= limit and e32x <= limit,
              f"{what} {key}: float32 card vs cpu")


def phase_sam2_masker(work, pipe, preset="large"):
    """Phase 9b: SAM2Masker on a seeded SAM2Config.large() checkpoint
    (sam2_hiera_large.pt, the released layout) over the views phase 8's
    pass 1 rendered (8 at 1554x1162, image size 1024): per-frame encode and
    track ms, peak memory, every mask's files and shape, the fill; then
    view 0 on the card against the CPU as phase 9a holds tiny/128.
    ``preset`` names another config (a CPU rehearsal runs "tiny")."""
    import copy

    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.pipeline import Renderer, SAM2Masker
    from gs2mesh_torch.sam2 import SAM2Config, SAM2VideoPredictor
    from gs2mesh_torch.sam2.predictor import read_frame

    base, colmap_dir, out_root, args = pipe
    t0 = time.perf_counter()
    cfg = getattr(SAM2Config, preset)()
    state, _ = sam2_seeded(cfg)
    ckpt = os.path.join(work, f"sam2_hiera_{preset}.pt")
    torch.save({"model": state}, ckpt)
    n_params = sum(v.numel() for v in state.values())
    del state
    log(f"sam2 {preset}: {n_params} weights written to {ckpt} "
        f"({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    r = Renderer(base, colmap_dir, out_root, args, device="cuda")
    t0 = time.perf_counter()
    masker = SAM2Masker(r, sam2_checkpoint=ckpt, device="cuda")
    check(masker.predictor.cfg == cfg, f"{preset} preset")
    log(f"sam2 {preset}: SAM2Masker built (checkpoint load + to cuda) in "
        f"{time.perf_counter() - t0:.1f} s")

    pred, core = masker.predictor, masker.predictor.core
    plain_encode, plain_track = core.encode, pred._track_frame

    def timed(fn, out):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return res
        return run

    enc, trk = [], []
    core.encode = timed(plain_encode, enc)
    pred._track_frame = timed(plain_track, trk)
    for i in range(len(r)):
        os.remove(os.path.join(r.render_folder_name(i), "left_mask.npy"))
        os.remove(os.path.join(r.render_folder_name(i), "left_mask.png"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        masker.segment()
        torch.cuda.synchronize()
    finally:
        core.encode, pred._track_frame = plain_encode, plain_track
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(r)
    check(len(enc) == n and len(trk) == n - 1,
          f"one encode a view ({len(enc)}), one track a later view "
          f"({len(trk)})")
    # _track_frame encodes its own frame: its track time is the rest.
    tracks = [t - e for t, e in zip(trk, enc[1:])]
    fills = []
    for i in range(n):
        view = r.render_folder_name(i)
        m = np.load(os.path.join(view, "left_mask.npy"))
        png = read_png(os.path.join(view, "left_mask.png"))
        check(m.dtype == np.bool_ and m.shape == (r.left_cameras[i]["height"],
                                                  r.left_cameras[i]["width"]),
              f"view {i}: mask {m.dtype} {m.shape}")
        check(png.shape == m.shape and np.array_equal(png > 0, m),
              f"view {i}: left_mask.png")
        fills.append(float(m.mean()))
    log(f"sam2 {preset} segment() over {n} views at "
        f"{m.shape[1]}x{m.shape[0]} (image size {cfg.image_size}): wall "
        f"{wall:.2f} s; "
        f"encode ms a frame {['%.1f' % x for x in enc]} (median "
        f"{np.median(enc):.1f}); track ms a frame after the encode "
        f"{['%.1f' % x for x in tracks]} (median {np.median(tracks):.1f}); "
        f"peak device memory {peak:.3f} GiB; mask fill "
        f"{['%.3f' % f for f in fills]}")

    # View 0 at this preset's full width on the card against the CPU: the
    # encoder's FPN levels and the low-res logits of segment()'s box prompt.
    frame = read_frame(os.path.join(r.render_folder_name(0), "left.png"))
    h, w = frame.shape[:2]
    box = np.array([0.02 * w, 0.02 * h, 0.98 * w, 0.98 * h])
    net = copy.deepcopy(pred.core.model).cpu()
    del masker, pred, core
    torch.cuda.empty_cache()

    def run(dev, dtype):
        vid = SAM2VideoPredictor(copy.deepcopy(net).to(dtype), device=dev)
        state = vid.init_state(frames=[frame])
        vid.add_new_points_or_box(state, 0, box=box)
        high_res, feat, _ = state["features"][0]
        out = {f"fpn {i}": f.cpu().numpy()
               for i, f in enumerate(high_res + [feat])}
        out["low-res logits"] = (
            state["cond_outputs"][0]["pred_masks"].cpu().numpy())
        return out

    t0 = time.perf_counter()
    compare_card_cpu({(d, t): run(d, t) for d in ("cpu", "cuda")
                      for t in (torch.float64, torch.float32)},
                     f"sam2 {preset}/{cfg.image_size} view 0")
    log(f"sam2 {preset} view 0 card vs cpu: {time.perf_counter() - t0:.1f} s")


def lpips_flops(h, w):
    """Multiply-adds x 2 of the VGG16 trunk LPIPS runs on one h x w image."""
    from gs2mesh_torch.metrics.lpips import _VGG16_PLAN

    ops, cin = 0, 3
    for spec in _VGG16_PLAN:
        if spec == "M":
            h, w = h // 2, w // 2
        else:
            ops += 2 * h * w * 9 * cin * spec
            cin = spec
    return ops


def phase_gs_tools(work, iters=(20, 40)):
    """Phase 10: gs_full_eval on the training phase's scene (8 PNG views at
    960x576, 300k points, eval split: view 0 is the test view) for 40
    iterations with checkpoints at 20 and 40, each stage timed; then
    gs_metrics(lpips=True) with seeded VGG16 and LPIPS head files; LPIPS on
    the card against the CPU on one pair; render_golden on the card
    against K2 on a 3000-gaussian 64x64 scene. Returns K1-K4's launches
    over gs_full_eval."""
    from gs2mesh_torch.cli import gs_tools
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.metrics import init_lpips_params, load_lpips, lpips
    from gs2mesh_torch.models.gaussians import GaussianModel, params_from_numpy
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
    from gs2mesh_torch.ops.rasterizer.golden import render_golden

    src = os.path.join(work, "train_scene")
    out = os.path.join(work, "gs_tools")
    images = os.path.join(src, "images")
    size = read_png(os.path.join(images, sorted(os.listdir(images))[0])
                    ).shape[:2]
    trainers, walls = [], {}
    plain = {k: getattr(gs_tools, k)
             for k in ("gs_train", "gs_render", "gs_metrics")}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = plain[name](*a, **kw)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t)
            if name == "gs_train":
                trainers.append(res)
            return res
        return run

    counters = path_wrappers()
    for k in plain:
        setattr(gs_tools, k, timed(k))
    for k in counters.values():
        k.launches = 0
    try:
        t0 = time.perf_counter()
        res = gs_tools.gs_full_eval([src], out, iterations=iters,
                                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, fn in plain.items():
            setattr(gs_tools, k, fn)
    launches = read_launches(counters, "gs_tools")
    tr = trainers[0]
    model_path = os.path.join(out, "train_scene")
    # An overflowed step doubles the capacity and is redone (K1 and K2
    # again); each checkpoint renders the test views once.
    redos = int(round(math.log2(tr.rcfg.pair_capacity
                                / RasterizerConfig().pair_capacity)))
    renders = sum(len(os.listdir(os.path.join(
        model_path, "test", f"ours_{it}", "renders"))) for it in iters)
    want = {"K1": iters[-1] + redos + renders,
            "K2": iters[-1] + redos + renders,
            "K3": iters[-1], "K4": iters[-1]}
    log(f"gs_full_eval (python -m gs2mesh_torch.cli.gs_tools train / render "
        f"/ metrics) on {src}: wall {wall:.2f} s; by stage "
        f"{ {k: ['%.2f s' % x for x in v] for k, v in walls.items()} }; "
        f"results {res}; pair capacity {tr.rcfg.pair_capacity} ({redos} "
        f"overflow redos); launches {launches} (implied {want})")
    check(tr.iteration == iters[-1], f"gs_full_eval trained {iters[-1]} "
          f"iterations")
    check(launches == want, f"gs_full_eval launches {launches} != {want}")
    for it in iters:
        for kind in ("renders", "gt"):
            img = read_png(os.path.join(model_path, "test", f"ours_{it}",
                                        kind, "00000.png"))
            check(img.shape == size + (3,), f"ours_{it} {kind} shape")
        m = res[model_path][f"ours_{it}"]
        check(all(math.isfinite(v) for v in m.values()) and 0 < m["SSIM"]
              <= 1 and m["PSNR"] > 0, f"ours_{it} metrics {m}")

    # gs_metrics with LPIPS, seeded weights as the two files it reads.
    state = init_lpips_params(seed=1)
    vgg = os.path.join(work, "vgg16.pth")
    lin = os.path.join(work, "lpips_lin.pth")
    torch.save({k: v for k, v in state.items() if k.startswith("features.")},
               vgg)
    torch.save({f"lin{i}.model.1.weight": state[f"lins.{i}"].reshape(
        1, -1, 1, 1) for i in range(5)}, lin)
    os.environ["GS2MESH_LPIPS_VGG"], os.environ["GS2MESH_LPIPS_LIN"] = vgg, lin
    t0 = time.perf_counter()
    scored = gs_tools.gs_metrics([model_path], lpips=True, device="cuda")
    torch.cuda.synchronize()
    log(f"gs_metrics(lpips=True): {time.perf_counter() - t0:.2f} s, "
        f"{scored}")
    for it in iters:
        v = scored[model_path][f"ours_{it}"]["LPIPS"]
        check(math.isfinite(v) and v >= 0, f"ours_{it} LPIPS {v}")
    a = torch.from_numpy(read_png(os.path.join(
        model_path, "test", f"ours_{iters[-1]}", "renders", "00000.png"))
        .astype(np.float32).transpose(2, 0, 1) / 255.0)[None]
    b = torch.from_numpy(read_png(os.path.join(
        model_path, "test", f"ours_{iters[-1]}", "gt", "00000.png")).astype(
        np.float32).transpose(2, 0, 1) / 255.0)[None]
    card, cpu = load_lpips(state, "cuda"), load_lpips(state, "cpu")
    a_dev, b_dev = a.cuda(), b.cuda()
    with torch.no_grad():
        v_card = float(lpips(card, a_dev, b_dev)[0])
        v_cpu = float(lpips(cpu, a, b)[0])
        ms = cuda_time_ms(lambda: lpips(card, a_dev, b_dev), 5)
    gap = abs(v_card - v_cpu) / max(abs(v_cpu), 1e-30)
    flops = 2 * lpips_flops(*size)
    log(f"LPIPS {size[1]}x{size[0]} card {v_card:.7f} vs cpu {v_cpu:.7f}: "
        f"relative gap {gap:.3e} (limit {LPIPS_PAIR_TOL:.0e}); {ms:.2f} "
        f"ms a pair on the card, {flops / 1e9:.1f} GFLOP of convolutions "
        f"({flops / ms / 1e9:.1f} TFLOP/s)")
    check(gap <= LPIPS_PAIR_TOL, "LPIPS card vs cpu")

    # The golden renderer on the card against K2.
    d = sphere_scene(3000, seed=4)
    inp = GaussianModel(params_from_numpy(d, device="cuda"), 3).raster_inputs()
    R, t = look_at((0.3, 0.2, -3.0))
    cam = make_camera(R.T, t, math.radians(50), math.radians(50), 64, 64,
                      device="cuda")
    args = [inp[k] for k in ("means3d", "scales", "rotations", "opacities",
                             "shs")]
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    cfg = RasterizerConfig(pair_capacity=1 << 18)
    with torch.no_grad():
        k2 = rasterize(*args, cam, 3, bg=bg, cfg=cfg)
        gold, gold_T, _ = render_golden(*args, cam, 3, bg=bg, cfg=cfg)
    e_img = float((k2.image - gold).abs().max())
    e_T = float((k2.final_T - gold_T).abs().max())
    log(f"render_golden on the card vs K1/K2 (3000 gaussians, 64x64, "
        f"{int(k2.num_pairs)} pairs): image {e_img:.3e}, final_T {e_T:.3e} "
        f"(limit 2e-5)")
    check(not bool(k2.overflow) and e_img <= 2e-5 and e_T <= 2e-5,
          "render_golden vs K2 on the card")
    return launches


# Phase 11's limits are phase 9a's (compare_card_cpu), against the largest
# finite |value| of the CPU's output, the -inf positions (padded text
# columns) equal, and the outputs after the query selection decoded from
# the same picks (the CPU float64 run's) on both devices and in both dtypes.
GDINO_SMALL = (64, 96)           # phase 11a's card-vs-CPU image (H, W)
GDINO_STAGES = ("gdino.bert", "gdino.backbone", "gdino.encoder",
                "gdino.query_selection", "gdino.decoder")
GDINO_WORDS = ("main", "_", "object", "red", "car")


def gdino_small_config():
    """tests/test_gdino.py's small config (Swin embed 32, depths 1 each;
    BERT 64 wide, 2 layers; 20 queries; 2 + 2 layers)."""
    from gs2mesh_torch.gdino import GDINOConfig
    from gs2mesh_torch.gdino.bert import BertConfig
    from gs2mesh_torch.gdino.swin import SwinConfig

    return GDINOConfig(
        swin=SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 4, 8)),
        bert=BertConfig(hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128),
        num_queries=20, num_encoder_layers=2, num_decoder_layers=2)


def write_gdino_vocab(path):
    """A synthetic bert-base-uncased-shaped vocab.txt (30,522 lines:
    [PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, '.' 1012, '?'
    1029, the caption's words from 2000 on); the released one is not in
    the repository."""
    vocab = [f"[unused{i}]" for i in range(30522)]
    vocab[0], vocab[100], vocab[101], vocab[102], vocab[103] = (
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    vocab[1012], vocab[1029] = ".", "?"
    for i, w in enumerate(GDINO_WORDS):
        vocab[2000 + i] = w
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return path


def gdino_flops(cfg, h, w, n_text):
    """Multiply-adds x 2 of the products and attention of one forward of
    ``cfg`` on an h x w input with n_text tokens (Swin windows over their
    padded grids; the deformable sampling's 4 taps; the elementwise work
    not counted)."""
    ws, s = cfg.swin.window_size, cfg.swin
    ops, H, W = 2 * (h // 4) * (w // 4) * 48 * s.embed_dim, h // 4, w // 4
    levels = []
    for i, depth in enumerate(s.depths):
        C = s.embed_dim * 2 ** i
        n = (-(-H // ws) * ws) * (-(-W // ws) * ws)
        ops += depth * (24 * n * C * C + 4 * n * ws * ws * C)
        if i in s.out_indices:
            levels.append((H, W, C))
        if i < len(s.depths) - 1:
            ops += 2 * ((H + 1) // 2) * ((W + 1) // 2) * 4 * C * 2 * C
            H, W = (H + 1) // 2, (W + 1) // 2
    D = cfg.hidden_dim
    for H, W, C in levels:
        ops += 2 * H * W * C * D
    H, W, C = levels[-1]
    H, W = (H + 1) // 2, (W + 1) // 2
    ops += 2 * H * W * 9 * C * D
    S = sum(a * b for a, b, _ in levels) + H * W
    b = cfg.bert
    ops += b.num_layers * 2 * n_text * (4 * b.hidden_size ** 2
                                        + 2 * b.hidden_size
                                        * b.intermediate_size)
    nq, taps = cfg.num_queries, 4 * 4 * 4 * 2 * D    # levels x points x taps
    # value projection of nv tokens; offsets (256), weights (128) and
    # output projection of n queries; 4 bilinear taps a sample
    deform = lambda n, nv: 2 * (n * D * (D + 384) + nv * D * D) + n * taps
    ops += cfg.num_encoder_layers * (
        2 * S * D * 1024 * 3 + deform(S, S) + 4 * S * D * 2048)
    ops += 2 * S * D * D * 4 + 2 * S * D * n_text
    ops += cfg.num_decoder_layers * (
        2 * nq * D * D * 6 + 4 * nq * nq * D + deform(nq, S)
        + 4 * nq * D * 2048 + 2 * nq * D * D * 6)
    return ops, S


def gdino_seeded(cfg, seed=0):
    from gs2mesh_torch.gdino import GDINO, init_gdino_

    return init_gdino_(GDINO(cfg), torch.Generator().manual_seed(seed)
                       ).eval()


def compare_gdino_card_cpu(net, image, ids, what):
    """Phase 11's card-vs-CPU check of GroundingDINO on ``image`` (a
    preprocessed (1, H, W, 3) float32 CPU tensor) and ``ids`` ((1, nt)
    token ids) at phase 9a's limits (compare_card_cpu): the float64 top-k
    equal across devices; every run then decodes the CPU float64 run's
    picks, so the float32 outputs after the selection are held on both
    devices every time (near-tied logits may order apart in float32).
    Returns how many of the card's own float32 picks differ from the
    CPU's."""
    outs = {("cpu", torch.float64): gdino_outputs(net, "cpu", torch.float64,
                                                  image, ids)}
    picks = outs[("cpu", torch.float64)]["topk"]
    for dev, t in (("cuda", torch.float64), ("cpu", torch.float32),
                   ("cuda", torch.float32)):
        outs[(dev, t)] = gdino_outputs(net, dev, t, image, ids, picks)
    topk = {k: v.pop("topk") for k, v in outs.items()}
    check(np.array_equal(topk[("cuda", torch.float64)], picks),
          f"gdino {what}: float64 top-k equal across devices")
    n_diff = int((topk[("cpu", torch.float32)]
                  != topk[("cuda", torch.float32)]).sum())
    log(f"gdino {what}: float32 top-k indices that differ card vs cpu "
        f"{n_diff}, cpu float32 vs float64 "
        f"{int((topk[('cpu', torch.float32)] != picks).sum())}, of "
        f"{picks.size}; every output decodes the cpu float64 picks")
    compare_card_cpu(outs, f"gdino {what}")
    return n_diff


def gdino_outputs(net, dev, dtype, image, ids, topk=None):
    """gdino_encode of a copy of ``net`` on ``dev`` in ``dtype`` (TF32 off),
    then gdino_decode of ``topk`` (numpy, (1, nq); its own picks if None):
    the outputs, the encoder memory, the selection logits and its own
    picks ("topk") as numpy arrays."""
    import copy

    from gs2mesh_torch.core.precision import precision_scope
    from gs2mesh_torch.gdino import (gdino_decode, gdino_encode,
                                     prepare_text_inputs)

    m = copy.deepcopy(net).to(dev, dtype)
    with torch.no_grad(), precision_scope():
        enc = gdino_encode(m, image.to(dev, dtype),
                           *prepare_text_inputs(ids, m.cfg, dev))
        out = gdino_decode(m, enc, enc["topk"] if topk is None
                           else torch.from_numpy(topk).to(dev))
    out.update((k, enc[k]) for k in ("memory", "enc_logits", "topk"))
    res = {k: v.cpu().numpy() for k, v in out.items()}
    del m, enc, out
    torch.cuda.empty_cache()
    return res


def phase_gdino_checks():
    """Phase 11a: the small GroundingDINO on the golden test's inputs
    (tests/test_golden_fixtures.py: rng 3, a 64x96 image, ids [101, 5, 6,
    1012, 7, 102]) on the card against the CPU, float64 and float32."""
    net = gdino_seeded(gdino_small_config())
    rng = np.random.default_rng(3)
    rng.uniform(0, 255, (1, 3, 64, 96))
    rng.uniform(0, 255, (1, 3, 64, 96))
    img = torch.from_numpy(rng.normal(size=(1,) + GDINO_SMALL + (3,)).astype(
        np.float32))
    ids = np.array([[101, 5, 6, 1012, 7, 102]])
    n_diff = compare_gdino_card_cpu(net, img, ids, f"small/{GDINO_SMALL[0]}x"
                                    f"{GDINO_SMALL[1]}")
    check(n_diff == 0, "gdino small: float32 top-k equal across devices")


class _Stub:
    """Accepts any call or attribute: matplotlib's figure, axes, canvas and
    patches for a headless run of the interactive masker (the card's
    machine has no matplotlib); records the canvas callbacks."""

    def __init__(self):
        self.callbacks = {}

    def mpl_connect(self, name, fn):
        self.callbacks[name] = fn

    def __getattr__(self, name):
        if name == "canvas":
            return self
        return lambda *a, **k: None


def scripted_pyplot(events):
    """Module stubs for matplotlib, matplotlib.pyplot and
    matplotlib.patches whose show() plays ``events(ax)`` ((press, release)
    pairs) through the figure's callbacks."""
    import types

    fig, ax = _Stub(), _Stub()
    plt = types.ModuleType("matplotlib.pyplot")
    plt.subplots = lambda **kw: (fig, ax)

    def show(block=True):
        for press, release in events(ax):
            fig.callbacks["button_press_event"](press)
            fig.callbacks["button_release_event"](release)

    plt.show = show
    patches = types.ModuleType("matplotlib.patches")
    patches.Rectangle = lambda *a, **k: None
    mpl = types.ModuleType("matplotlib")
    mpl.pyplot, mpl.patches = plt, patches
    return {"matplotlib": mpl, "matplotlib.pyplot": plt,
            "matplotlib.patches": patches}


def phase_gdino(work, pipe):
    """Phase 11b and 11c: a seeded SwinT-OGC GroundingDINO written as
    groundingdino_swint_ogc.pth (the released layout) beside a synthetic
    vocab.txt; SAM2Masker(gdino_checkpoint=..., gdino_vocab=...,
    sam2_checkpoint=<phase 9b's sam2_hiera_large.pt>, box_threshold=0.0)
    .segment() over phase 8's 8 pass-1 views at 1554x1162; predict's ms cold
    and warm, the forward's device ms by gdino.* range, peak memory, the
    box and the masks; view 0 on the card against the CPU at full width;
    then the interactive masker on view 0 with scripted events."""
    import types

    import gs2mesh_torch.gdino as gdino
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.gdino import released_state_dict
    from gs2mesh_torch.gdino.inference import (preprocess_caption,
                                               preprocess_image)
    from gs2mesh_torch.pipeline import (Renderer, SAM2Masker,
                                        run_interactive_masker)
    from gs2mesh_torch.sam2.predictor import read_frame

    base, colmap_dir, out_root, args = pipe
    t0 = time.perf_counter()
    net = gdino_seeded(gdino.GDINOConfig())
    n_params = sum(p.numel() for p in net.parameters())
    ckpt = os.path.join(work, "groundingdino_swint_ogc.pth")
    torch.save({"model": released_state_dict(net.state_dict(),
                                             prefix="module.")}, ckpt)
    vocab = write_gdino_vocab(os.path.join(work, "vocab.txt"))
    log(f"gdino SwinT-OGC: {n_params} parameters written to {ckpt} "
        f"({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB, released layout) in "
        f"{time.perf_counter() - t0:.1f} s")
    sam2_ckpt = os.path.join(work, "sam2_hiera_large.pt")
    r = Renderer(base, colmap_dir, out_root, args, device="cuda")
    t0 = time.perf_counter()
    masker = SAM2Masker(r, prompt="main_object", gdino_checkpoint=ckpt,
                        gdino_vocab=vocab, sam2_checkpoint=sam2_ckpt,
                        box_threshold=0.0, device="cuda")
    log(f"gdino: SAM2Masker (SAM2-large) built in "
        f"{time.perf_counter() - t0:.1f} s")

    # segment(): predict timed (the cold call), the prompt SAM2 gets.
    plain_predict, plain_add = gdino.predict, masker.predictor \
        .add_new_points_or_box
    predict_ms, prompts = [], []

    def timed_predict(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = plain_predict(*a, **kw)
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t) * 1e3)
        return res

    def add(state, frame_idx, obj_id=0, **kw):
        prompts.append(dict(kw, frame_idx=frame_idx))
        return plain_add(state, frame_idx, obj_id, **kw)

    boxes = []
    plain_box = masker._gdino_box
    masker._gdino_box = lambda img: boxes.append(plain_box(img)) or boxes[-1]
    gdino.predict, masker.predictor.add_new_points_or_box = timed_predict, add
    for i in range(len(r)):
        os.remove(os.path.join(r.render_folder_name(i), "left_mask.npy"))
        os.remove(os.path.join(r.render_folder_name(i), "left_mask.png"))
    torch.cuda.synchronize()
    resident_segment = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        masker.segment()
        torch.cuda.synchronize()
    finally:
        gdino.predict = plain_predict
        masker.predictor.add_new_points_or_box = plain_add
        masker._gdino_box = plain_box
    wall = time.perf_counter() - t0
    peak_segment = (torch.cuda.max_memory_allocated() / 2 ** 30
                    - resident_segment)
    frame = read_frame(os.path.join(r.render_folder_name(0), "left.png"))
    h, w = frame.shape[:2]
    check(len(boxes) == 1 and boxes[0] is not None, "gdino: one view-0 box")
    box = boxes[0]
    log(f"gdino: segment() over {len(r)} views at {w}x{h}: wall {wall:.2f} "
        f"s (predict cold {predict_ms[0]:.1f} ms); view-0 box "
        f"{np.round(box, 2).tolist()}; peak device memory above the "
        f"{resident_segment:.3f} GiB resident before it (SAM2-large) "
        f"{peak_segment:.3f} GiB (GroundingDINO loaded, predict, SAM2's "
        f"tracking)")
    # best_box_xyxy (both packages, as masker_utils.py) scales the
    # network's sigmoid (cx, cy, w, h) to pixels without clipping: the
    # centre lies in the image and the extent is at most the image's, and
    # a seeded network's box may reach past an edge. Which query wins
    # turns on float32 rounding in phase 8's training: routes whose
    # gradients agree to rounding, or whose targets differ in a few
    # pixels, pick different queries, and some of their boxes reach past
    # the bottom (tools/preprocess_routes_torch.py).
    cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    check(np.isfinite(box).all() and box[0] < box[2] and box[1] < box[3]
          and 0 <= cx <= w and 0 <= cy <= h and box[2] - box[0] <= w
          and box[3] - box[1] <= h, f"gdino box {box}: centre in the "
          f"{w}x{h} image, extent within it")
    check(len(prompts) == 1 and prompts[0]["frame_idx"] == 0
          and np.array_equal(prompts[0]["box"], box)
          and prompts[0].get("points") is None,
          "gdino: its box seeded SAM2 on view 0")
    fills = []
    for i in range(len(r)):
        view = r.render_folder_name(i)
        m = np.load(os.path.join(view, "left_mask.npy"))
        png = read_png(os.path.join(view, "left_mask.png"))
        check(m.dtype == np.bool_ and m.shape == (r.left_cameras[i]["height"],
                                                  r.left_cameras[i]["width"]),
              f"gdino view {i}: mask {m.dtype} {m.shape}")
        check(png.shape == m.shape and np.array_equal(png > 0, m),
              f"gdino view {i}: left_mask.png")
        fills.append(float(m.mean()))
    log(f"gdino: mask fill {['%.3f' % f for f in fills]}")

    # predict warm: 3 calls, CUDA-synchronised; then one forward profiled.
    model, tokenizer = masker._gdino
    ids = np.asarray(tokenizer(preprocess_caption(masker.prompt))
                     ["input_ids"])
    warm = []
    torch.cuda.synchronize()
    resident_predict = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gdino.predict(model, frame, masker.prompt, box_threshold=0.0,
                      tokenizer=tokenizer)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    peak_predict = (torch.cuda.max_memory_allocated() / 2 ** 30
                    - resident_predict)
    x = preprocess_image(frame, "cuda")
    ops, S = gdino_flops(model.cfg, x.shape[1], x.shape[2], ids.size)
    from gs2mesh_torch.core.precision import precision_scope
    from gs2mesh_torch.gdino import gdino_forward, prepare_text_inputs
    text = prepare_text_inputs(ids, model.cfg, "cuda")

    def forward():
        with torch.no_grad(), precision_scope():
            return gdino_forward(model, x, *text)

    fwd_ms = cuda_time_ms(forward, 3)
    log(f"gdino predict at {w}x{h} -> {x.shape[2]}x{x.shape[1]} ({S} "
        f"tokens, {ids.size} text tokens): cold {predict_ms[0]:.1f} ms, warm "
        f"{['%.1f' % t for t in warm]} ms (median {np.median(warm):.1f}); "
        f"forward {fwd_ms:.2f} device ms (CUDA events), "
        f"{ops / 1e9:.1f} GFLOP of products ({ops / fwd_ms / 1e9:.1f} "
        f"TFLOP/s against the FP32 peak {PEAK_OPS_PER_S['fp32'] / 1e12:.0f}"
        f"); GroundingDINO's working memory over a predict (peak above the "
        f"{resident_predict:.3f} GiB resident: both models' weights and "
        f"the masker's state) {peak_predict:.3f} GiB")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    report_profile(prof, wall_us, 1, "forward")
    dev, host = range_times(prof, 1, ("gdino",))
    for name in GDINO_STAGES + ("outside",):
        log(f"  {name:22s} device {dev.get(name, 0.0):8.3f} ms, host "
            f"{host.get(name, 0.0):8.3f} ms")
    check(all(dev.get(s, 0.0) > 0 for s in GDINO_STAGES),
          "gdino: every stage ran on the device")

    # View 0 at full width on the card against the CPU.
    t0 = time.perf_counter()
    net = model.cpu()
    masker._gdino = None
    torch.cuda.empty_cache()
    x_cpu = preprocess_image(frame, "cpu")
    check(torch.equal(x_cpu, x.cpu()), "gdino: preprocess_image equal on "
          "card and cpu")
    compare_gdino_card_cpu(net, x_cpu, ids, f"SwinT-OGC {x.shape[2]}x"
                           f"{x.shape[1]} view 0")
    del net
    log(f"gdino view 0 card vs cpu: {time.perf_counter() - t0:.1f} s")

    # 11c: the interactive masker on view 0 with scripted events.
    ev = lambda ax, x, y, b: types.SimpleNamespace(inaxes=ax, xdata=x,
                                                    ydata=y, button=b)

    def events(ax):
        return [(ev(ax, w / 2, h / 2, 1), ev(ax, w / 2 + 1, h / 2, 1)),
                (ev(ax, 0.2 * w, 0.15 * h, 1), ev(ax, 0.8 * w, 0.85 * h, 1)),
                (ev(ax, 0.35 * w, 0.4 * h, 3), ev(ax, 0.35 * w, 0.4 * h, 3)),
                (ev(ax, 0.5 * w, 0.7 * h, 1), ev(ax, 0.5 * w, 0.7 * h, 1)),
                # a middle-click on the negative point, far from the box
                (ev(ax, 0.35 * w + 1, 0.4 * h - 1, 2),
                 ev(ax, 0.35 * w + 1, 0.4 * h - 1, 2))]

    preview_ms = []
    plain_preview = masker.preview_mask

    def preview(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = plain_preview(*a, **kw)
        torch.cuda.synchronize()
        preview_ms.append((time.perf_counter() - t) * 1e3)
        return res

    masker.preview_mask = preview
    saved = {k: sys.modules.get(k) for k in ("matplotlib",
                                             "matplotlib.pyplot",
                                             "matplotlib.patches")}
    sys.modules.update(scripted_pyplot(events))
    for i in range(len(r)):
        os.remove(os.path.join(r.render_folder_name(i), "left_mask.npy"))
    t0 = time.perf_counter()
    try:
        seeder = run_interactive_masker(r, masker)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        masker.preview_mask = plain_preview
    wall = time.perf_counter() - t0
    pts, lbl, sbox = seeder.seeds()
    log(f"gdino interactive masker on view 0: {len(preview_ms)} redraws, "
        f"preview_mask ms {['%.1f' % t for t in preview_ms]} (the first "
        f"encodes the view); seeds points {pts.tolist()} labels "
        f"{lbl.tolist()} box {np.round(sbox, 1).tolist()}; "
        f"run_interactive_masker wall {wall:.2f} s")
    check(len(preview_ms) == 5 and list(lbl) == [1, 1]
          and seeder.mask is not None and seeder.mask.shape == (h, w),
          "interactive masker: 5 previews, 2 positive points, a box")
    check(np.array_equal(masker.box, sbox) and np.array_equal(
        masker.points, pts), "interactive masker: its seeds reached SAM2")
    for i in range(len(r)):
        m = np.load(os.path.join(r.render_folder_name(i), "left_mask.npy"))
        check(m.dtype == np.bool_ and m.shape == (r.left_cameras[i]["height"],
                                                  r.left_cameras[i]["width"]),
              f"interactive masker view {i}: mask {m.dtype} {m.shape}")


# ------------------------------------------------------------ phases 12-17
# The strided tile-row mode of K1-K3, the sharded trainer and inference in
# a world of one, the viewer, the SIBR network GUI, utils / viz.

STRIDES = (2, 4, 8)


def strided_forward(eargs, G, ax, capacity=None):
    """K1 -> sort -> K2 on rank ax's strided slice of the emission inputs,
    the slice's sort key sized for the whole image (so each tile orders its
    pairs as the unsharded render does)."""
    import dataclasses

    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda, sort_pairs
    from gs2mesh_torch.parallel.sharded_train import local_rects, slice_rows

    feat9, depths, rect, tt, W, H, cfg = eargs
    gx, gy = cfg.grid_size(W, H)
    rows_per, h_slice = slice_rows(H, cfg, G)
    rect_loc, tiles_loc = local_rects(rect, tt, rows_per, ax, G)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, pair_capacity=capacity)
    sargs = (feat9, depths, rect_loc, tiles_loc, W, h_slice, cfg, ax, G,
             gx * gy)
    em = emission_cuda(*sargs)
    pairs = sort_pairs(em, gx * rows_per, key_tiles=gx * gy)
    strided = dict(row_offset=ax, row_stride=G)
    color, final_T = composite_cuda(pairs.ids, pairs.tile_starts,
                                    pairs.tile_counts, feat9, W, h_slice, cfg,
                                    **strided)
    return dict(sargs=sargs, em=em, pairs=pairs, color=color,
                final_T=final_T, tiles_loc=tiles_loc, rows_per=rows_per,
                h_slice=h_slice, cfg=cfg, W=W, strided=strided,
                num_tiles=gx * rows_per, key_tiles=gx * gy)


def strided_backward(s, feat9, dC, dT):
    """K3 (with its fill) on a strided slice: per-pair rows at its emission
    slots."""
    from gs2mesh_torch.ops.rasterizer.composite import composite_backward_cuda

    p = s["pairs"]
    return composite_backward_cuda(
        p.ids, p.order, p.tile_starts, p.tile_counts, p.num_pairs, feat9,
        s["color"], s["final_T"], dC, dT, s["W"], s["h_slice"], s["cfg"],
        **s["strided"])


def phase_strided_vs_plain(narrow):
    """Phase 12a: each strided kernel against its plain version on phase
    3's 60k narrow-splat scene at 360x200 (7 tile rows: at G = 8 one slice
    owns none), every slice of G = 2, 4, 8: K1 bit-exact, K2 2e-5, K3 / K4
    at compare_backward's limits."""
    from gs2mesh_torch.ops.rasterizer.emit import (emission_plain,
                                                   segment_sum_cuda)
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_backward_plain, composite_plain, pair_rows)

    _, _, feat9, prep, _, _, W, H, cfg = narrow
    eargs = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
    errs = {"k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0}
    with torch.no_grad():
        for G in STRIDES:
            for ax in range(G):
                what = f"60k narrow/360x200 G={G} slice {ax}"
                s = strided_forward(eargs, G, ax)
                p = s["pairs"]
                _, e1 = compare_emission(s["em"], emission_plain(*s["sargs"]),
                                         s["num_tiles"], what,
                                         key_tiles=s["key_tiles"])
                if int(p.num_pairs) == 0:
                    check(bool((s["final_T"] == 1).all())
                          and not bool(s["color"].ne(0).any()),
                          f"{what}: an empty slice composites to T = 1")
                    log(f"{what}: empty (no tile row of the image)")
                    continue
                rows = pair_rows(feat9, p.ids)
                mpt = int(p.tile_counts.max())
                plain = composite_plain(rows, p.tile_starts, p.tile_counts, W,
                                        s["h_slice"], cfg, mpt,
                                        **s["strided"])
                e2 = compare_composite(s["color"], s["final_T"], plain.color,
                                       plain.final_T, what)
                dC, dT = loss_cotangents(s["color"], s["final_T"])
                k3 = strided_backward(s, feat9, dC, dT)
                k4 = segment_sum_cuda(k3, p.offsets, s["tiles_loc"])
                plain3 = torch.zeros_like(k3)
                plain3[p.order] = composite_backward_plain(
                    rows, p.tile_starts, p.tile_counts, dC, dT, W,
                    s["h_slice"], cfg, mpt, **s["strided"])
                e3, e4 = compare_backward(k3, k4, plain3, p, s["tiles_loc"],
                                          what)
                for k, e in zip(errs, (e1, e2, e3, e4)):
                    errs[k] = max(errs[k], e)
    log(f"strided kernels vs plain, largest errors over every slice: {errs}")
    return errs


def slice_tile_sums(per_tile, G, ax, gx, gy):
    """Sum of a (T,) per-tile count over the global tile rows rank ax owns."""
    rows = torch.arange(ax, gy, G, device=per_tile.device)
    return int(per_tile.reshape(gy, gx)[rows].sum())


def phase_strided(serving):
    """Phase 12: K1 and K2 slice by slice on phase 4's serving view (300k
    SH-3, 960x576) for G = 2, 4, 8: the stitched colour and final_T
    bit-equal to the unsharded K2 render, the slices' pairs summing to the
    unsharded count, K3 per slice with K4 per slice summed over the slices
    within compare_backward's limits of the unsharded K3 + K4 gradient; each
    kernel's ms per slice beside per-slice bounds counted as for the
    unsharded rows (K2 / K3 operations from phase 5's plain per-tile
    counts, feat9 bytes for the rows each slice's pairs gather). Each
    slice's capacity is its largest slice's pair count
    rounded up to 64Ki. Returns {G: numbers} for the kernels line."""
    from gs2mesh_torch.ops.rasterizer.emit import segment_sum_cuda
    from gs2mesh_torch.parallel.sharded_train import (image_slice,
                                                      local_rects, slice_rows,
                                                      stitch_slices)

    eargs, plain = serving["eargs"], serving["plain"]
    feat9, depths, rect, tt, W, H, cfg = eargs
    N = feat9.shape[0]
    gx, gy = cfg.grid_size(W, H)
    out = {}
    with torch.no_grad():
        em, pairs, color, final_T = run_forward_kernels(eargs)
        dC, dT = loss_cotangents(color, final_T)
        k3, k4 = run_backward_kernels(pairs, feat9, tt, color, final_T, dC,
                                      dT, W, H, cfg)
        n_all = int(em.num_pairs)
        for G in STRIDES:
            what = f"300k/960x576 strided G={G}"
            rows_per, h_slice = slice_rows(H, cfg, G)
            counts = [int(local_rects(rect, tt, rows_per, ax, G)[1].sum())
                      for ax in range(G)]
            cap = -(-max(counts) // (1 << 16)) * (1 << 16)
            slices = [strided_forward(eargs, G, ax, cap) for ax in range(G)]
            c = stitch_slices([s["color"] for s in slices], H, cfg.tile)
            t = stitch_slices([s["final_T"][None] for s in slices], H,
                              cfg.tile)[0]
            same = torch.equal(c, color) and torch.equal(t, final_T)
            n_diff = int((c != color).sum() + (t != final_T).sum())
            pairs_s = [int(s["em"].num_pairs) for s in slices]
            live = [int(s["pairs"].tile_counts.sum()) for s in slices]
            log(f"{what}: stitched K2 colour / final_T bit-equal to the "
                f"unsharded render: {same} ({n_diff} values differ); pairs "
                f"per slice {pairs_s} (sum {sum(pairs_s)}, unsharded "
                f"{n_all}; capacity {cap}); live pairs per slice max / mean "
                f"{max(live) / np.mean(live):.3f}")
            check(same, f"{what}: stitched render differs in {n_diff} values")
            check(sum(pairs_s) == n_all and pairs_s == counts,
                  f"{what}: slice pairs {pairs_s} vs {n_all}")
            check(not any(bool(s["em"].overflow) for s in slices),
                  f"{what}: slice overflow")
            grad = torch.zeros_like(k4)
            cots = []
            for ax, s in enumerate(slices):
                dC_s = image_slice(dC, G, ax, h_slice, cfg.tile)
                dT_s = image_slice(dT[None], G, ax, h_slice, cfg.tile)[0]
                r3 = strided_backward(s, feat9, dC_s, dT_s)
                grad += segment_sum_cuda(r3, s["pairs"].offsets,
                                         s["tiles_loc"])
                cots.append((dC_s, dT_s))
            scale = k4.abs().amax(0)
            gap = (grad - k4).abs()
            share = float((gap <= 2e-3 * k4.abs() + 1e-4 * scale)
                          .float().mean())
            rel = float((gap / scale.clamp_min(1e-30)).max())
            log(f"{what}: K3 per slice + K4 per slice summed over the "
                f"slices vs the unsharded K3 + K4: {100 * share:.5f}% within "
                f"tolerance, largest gap / column max {rel:.3e}, max abs err "
                f"{float(gap.max()):.3e}")
            check(share >= 0.999 and rel <= 1e-3,
                  f"{what}: summed slice gradients disagree")

            ms = {"k1": [], "k2": [], "k3": []}
            bounds = {"k1": [], "k2": [], "k3": []}
            for ax, (s, (dC_s, dT_s)) in enumerate(zip(slices, cots)):
                p = s["pairs"]
                ms["k1"].append(cuda_time_ms(
                    lambda: strided_forward_k1(s), 20, queued=True))
                ms["k2"].append(cuda_time_ms(
                    lambda: strided_forward_k2(s, feat9), 20, queued=True))
                ms["k3"].append(cuda_time_ms(
                    lambda: strided_backward(s, feat9, dC_s, dT_s), 10,
                    queued=True))
                n_live = int(p.tile_counts.sum())
                # The feat9 rows this slice's live pairs gather.
                n_rows = int(torch.unique(p.ids[:n_live]).numel())
                ev = slice_tile_sums(plain.tile_evaluated, G, ax, gx, gy)
                acc = slice_tile_sums(plain.tile_accepted, G, ax, gx, gy)
                ops2 = ev * OPS_PER_EVAL + acc * K2_OPS_PER_ACCEPTED
                ops3 = ev * OPS_PER_EVAL + acc * K3_OPS_PER_ACCEPTED
                px = W * h_slice
                tiles = gx * rows_per
                bounds["k1"].append(bound(*emission_work(
                    N, cap, int(p.num_pairs)))[0])
                bounds["k2"].append(bound(
                    n_live * 4 + tiles * 8 + n_rows * 36 + 4 * px * 4,
                    ops2)[0])
                bounds["k3"].append(bound(
                    n_live * (4 + 8 + 36) + n_rows * 36 + 8 * px * 4
                    + tiles * 8, ops3)[0])
            for k in ms:
                log(f"{what}: {k.upper()} ms per slice "
                    + ", ".join(f"{v:.4f}" for v in ms[k])
                    + " (mean {:.4f}); bound per slice ".format(
                        np.mean(ms[k]))
                    + ", ".join(f"{v:.4f}" for v in bounds[k]))
            out[G] = dict(ms=ms, bounds=bounds, pairs=pairs_s,
                          balance=max(live) / np.mean(live), capacity=cap,
                          grad_err=float(gap.max()))
    return out


def strided_forward_k1(s):
    from gs2mesh_torch.ops.rasterizer.emit import emission_cuda

    return emission_cuda(*s["sargs"])


def strided_forward_k2(s, feat9):
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda

    p = s["pairs"]
    return composite_cuda(p.ids, p.tile_starts, p.tile_counts, feat9, s["W"],
                          s["h_slice"], s["cfg"], **s["strided"])


def init_world_one(work):
    """A process group of one rank over NCCL, from a file store."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"file://{work}/dist_store",
                            world_size=1, rank=0)
    check(dist.get_backend() == "nccl", "NCCL backend")


def phase_sharded_train(work):
    """Phase 13: ShardedTrainer on a (1 x 1) mesh over NCCL, phase 6's 25
    steps (from 3090, a densify at 3100, an opacity reset after 20) on phase
    6's scene, beside the single-device Trainer on the same seeds: the first
    step's params within atol 5e-5, every step's loss within 1e-4 relative,
    the alive count after the densify equal, K1-K4 once per taken step; the
    step walls side by side. Returns the sharded run's launches."""
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig
    from gs2mesh_torch.parallel import ShardedTrainer, make_mesh
    from gs2mesh_torch.train.scene import load_colmap_scene
    from gs2mesh_torch.train.trainer import TrainConfig, Trainer

    scene = load_colmap_scene(os.path.join(work, "train_scene"),
                              device="cuda")
    mesh = make_mesh(1, 1, "cuda")
    rcfg = RasterizerConfig(pair_capacity=1 << 22)
    runs = {}
    counters = path_wrappers()
    for name in ("trainer", "sharded"):
        model = GaussianModel.from_point_cloud(
            scene.points, scene.colors,
            spatial_lr_scale=scene.nerf_norm_radius, device="cuda")
        kw = dict(model=model, cameras=scene.cameras, images=scene.images,
                  cfg=TrainConfig(), rcfg=rcfg,
                  scene_extent=scene.nerf_norm_radius)
        tr = (Trainer(**kw, device="cuda") if name == "trainer"
              else ShardedTrainer(mesh=mesh, **kw))
        rec = dict(loss=[], ms=[], alive={}, first=None)
        last = [None]

        def cb(t, out, rec=rec):
            torch.cuda.synchronize()
            now = time.perf_counter()
            rec["ms"].append((now - last[0]) * 1e3)
            last[0] = now
            rec["loss"].append(float(out.loss))
            if rec["first"] is None:
                rec["first"] = [p.detach().clone()
                                for p in t.model.params.tensors()]
            if t.iteration in (3099, 3100):
                rec["alive"][t.iteration] = t.num_alive()

        tr.iteration = 3090
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        tr.train(20, callback=cb)
        tr.reset_opacity()
        tr.train(5, callback=cb)
        torch.cuda.synchronize()
        rec["launches"] = read_launches(counters, name)
        runs[name] = rec
        del tr, model
    a, b = runs["trainer"], runs["sharded"]
    p_err = max(float((x - y).abs().max()) if x.numel() else 0.0
                for x, y in zip(a["first"], b["first"]))
    l_err = max(abs(x - y) / abs(x) for x, y in zip(a["loss"], b["loss"]))
    steady = [i for i in range(1, 25) if i not in (9, 20)]
    log(f"sharded (1x1, NCCL) vs Trainer over 25 steps: first-step params "
        f"max abs diff {p_err:.3e} (limit 5e-5), loss max relative diff "
        f"{l_err:.3e} (limit 1e-4), alive before / after the densify "
        f"{a['alive']} / {b['alive']}; launches {b['launches']}")
    wa, wb = ([r["ms"][i] for i in steady] for r in (a, b))
    log(f"step wall ms (steps 2-25 without the densify and reset steps), "
        f"median (range): Trainer {np.median(wa):.2f} ({min(wa):.2f}-"
        f"{max(wa):.2f}), ShardedTrainer {np.median(wb):.2f} "
        f"({min(wb):.2f}-{max(wb):.2f})")
    check(len(b["loss"]) == 25 and len(a["loss"]) == 25, "25 steps each")
    check(p_err <= 5e-5, f"first-step params differ by {p_err}")
    check(l_err <= 1e-4, f"losses differ by {l_err} relative")
    check(a["alive"] == b["alive"], "alive counts around the densify")
    check(all(v == 25 for v in b["launches"].values()),
          f"K1-K4 launches once per sharded step: {b['launches']}")
    return b["launches"], dict(trainer_ms=float(np.median(wa)),
                               sharded_ms=float(np.median(wb)))


def phase_sharded_inference(stereo_pngs):
    """Phase 14: make_sharded_dlnr (a (1 x 1) mesh's data axis) on two of
    phase 5b's served stereo pairs at 960x576 (the seeded DLNR, 10
    iterations) and make_sharded_integrate on phase 5c's 20-view test
    sphere, each against the unsharded call."""
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.fusion import TSDFConfig
    from gs2mesh_torch.fusion.tsdf import allocate, create_volume
    from gs2mesh_torch.parallel import (gather_volume, make_mesh,
                                        make_sharded_dlnr,
                                        make_sharded_integrate, shard_volume)
    from gs2mesh_torch.stereo import DLNR, DLNRConfig, dlnr_forward, init_dlnr_

    mesh = make_mesh(1, 1, "cuda")
    model = init_dlnr_(DLNR(), torch.Generator().manual_seed(0)).eval()
    model = model.cuda()

    def batch(side):
        return torch.stack([torch.from_numpy(read_png(p[side]).astype(
            np.float32)).permute(2, 0, 1) for p in stereo_pngs]).cuda()

    im1, im2 = batch("left"), batch("right")
    cfg = DLNRConfig(iters=10)
    with torch.no_grad():
        ref = dlnr_forward(model, im1, im2, cfg)
        got = make_sharded_dlnr(mesh, cfg)(model, im1, im2)
    torch.cuda.synchronize()
    gaps = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, ref)]
    log(f"sharded DLNR (world 1) vs dlnr_forward on {tuple(im1.shape)}: "
        f"flow_low / disparity max |diff| / max |value| {gaps[0]:.3e} / "
        f"{gaps[1]:.3e} (limit 1e-5)")
    check(max(gaps) <= 1e-5, "sharded DLNR differs")

    tcfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.06, block_capacity=4096,
                      alloc_stride=2)
    views = list(small_sphere_views())
    vol, _ = fuse(views, tcfg, "cuda", 3.0)
    shard = shard_volume(create_volume(tcfg, "cuda"), mesh)
    step = make_sharded_integrate(tcfg)
    for color, depth, K, E in views:
        color, depth, K, E = (torch.as_tensor(a).cuda()
                              for a in (color, depth, K, E))
        shard = allocate(shard, depth, K, E, 3.0, tcfg)
        shard = step(shard, color, depth, K, E, 3.0)
    got = gather_volume(shard, mesh)
    same = all(torch.equal(getattr(got, k), getattr(vol, k))
               for k in ("keys", "order", "tsdf", "weight", "color"))
    log(f"sharded integrate (world 1) vs the single-device volume over "
        f"{len(views)} views: {got.n_blocks} blocks, bit-equal {same}")
    check(same and got.n_blocks == vol.n_blocks, "sharded integrate differs")


def http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def phase_viewer(work, n_requests=20, size=(960, 540)):
    """Phase 15: ViewerServer(device="cuda") on phase 4's PLY at 960x540 on
    a free port: GET / and /info, then n_requests /render at seeded orbit
    poses, each PNG decoded and held byte for byte to the quantised K1/K2
    render of the same camera; K1 / K2 launched once per request; ms a
    request (client wall), the render's device ms and the PNG encode ms.
    Returns the launches."""
    from gs2mesh_torch.core.png import decode_png
    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.train.trainer import render_model
    from gs2mesh_torch.viewer import ViewerServer, orbit_camera, quantize

    model = GaussianModel.load_ply(os.path.join(work, "point_cloud.ply"),
                                   device="cuda")
    W, H = size
    srv = ViewerServer(model, width=W, height=H, pair_capacity=1 << 23,
                       port=0, device="cuda")
    port = srv.start()
    counters = path_wrappers()
    try:
        page, ctype = http_get(port, "/")
        check(ctype.startswith("text/html") and b"viewer" in page, "page")
        info = json.loads(http_get(port, "/info")[0])
        check((info["width"], info["height"]) == (W, H), "info")
        http_get(port, "/render?az=0&el=15")           # warm-up
        rng = np.random.default_rng(0)
        poses = [(float(rng.uniform(-180, 180)), float(rng.uniform(-60, 60)),
                  float(srv.radius * rng.uniform(0.8, 1.3)))
                 for _ in range(n_requests)]
        srv.timings.clear()
        for k in counters.values():
            k.launches = 0
        pngs, walls = [], []
        for az, el, r in poses:
            t0 = time.perf_counter()
            png, ctype = http_get(port, f"/render?az={az}&el={el}&r={r}")
            walls.append((time.perf_counter() - t0) * 1e3)
            check(ctype == "image/png", "png answer")
            pngs.append(png)
        launches = read_launches(counters, "viewer")
    finally:
        srv.stop()
    n_pairs = []
    with torch.no_grad():
        for (az, el, r), png in zip(poses, pngs):
            cam = orbit_camera(srv.target, r, az, el, 60.0, W, H)
            out = render_model(srv.params, srv.alive, cam, srv.sh_degree,
                               srv.bg, srv.rcfg)
            n_pairs.append(int(out.num_pairs))
            check(np.array_equal(decode_png(png), quantize(out.image)),
                  f"viewer PNG at ({az:.1f}, {el:.1f}) differs from its "
                  f"render")
    dev = [t["device_ms"] for t in srv.timings
           if t["device_ms"] is not None] or [float("nan")]
    enc = [t["encode_ms"] for t in srv.timings]
    log(f"viewer: {n_requests} /render at {W}x{H} ({min(n_pairs)}-"
        f"{max(n_pairs)} pairs): each PNG byte-equal to the quantised K1/K2 "
        f"render; ms a request median {np.median(walls):.2f} ({min(walls):.2f}"
        f"-{max(walls):.2f}); render device ms median {np.median(dev):.3f} "
        f"({min(dev):.3f}-{max(dev):.3f}); PNG encode ms median "
        f"{np.median(enc):.2f} ({min(enc):.2f}-{max(enc):.2f}); launches "
        f"{launches}")
    check(launches["K1"] == launches["K2"] == n_requests
          and launches["K3"] == launches["K4"] == 0,
          f"viewer launches {launches}")
    return launches, dict(request_ms=walls, device_ms=dev, encode_ms=enc)


def phase_network_gui(work, iters=10, size=(960, 576)):
    """Phase 16: gs_tools.gs_train(gui=True) on phase 10's scene for
    `iters` iterations with a scripted SIBR client in a thread asking for
    960x576 frames (each frame's byte count and the verify string checked),
    then once without a client; then, with the training done, one frame of
    the final model served to the client and held to a direct render. ms a
    GUI frame (serve_step) and the train step with and without the client.
    Returns K1-K4's launches of the run with the client."""
    import socket
    import threading

    from gs2mesh_torch.cli import gs_tools
    from gs2mesh_torch.core.camera import make_camera
    from gs2mesh_torch.train import network_gui, trainer as trainer_mod
    from gs2mesh_torch.train.trainer import render_model

    src = os.path.join(work, "train_scene")
    W, H = size
    R, t = look_at((0.3, -0.2, -2.9))
    fov = math.radians(60)
    cam = make_camera(R.T, t, fov, 2 * math.atan(H / W * math.tan(fov / 2)),
                      W, H)
    view = cam.world_view.cpu().numpy().copy()
    view[:, 1:3] *= -1
    proj = cam.full_proj.cpu().numpy().copy()
    proj[:, 1] *= -1
    msg = json.dumps(dict(
        resolution_x=W, resolution_y=H, train=True, keep_alive=False,
        scaling_modifier=1.0, view_matrix=view.reshape(-1).tolist(),
        view_projection_matrix=proj.reshape(-1).tolist(), fov_x=fov,
        fov_y=2 * math.atan(H / W * math.tan(fov / 2)), z_near=0.01,
        z_far=100.0)).encode()

    def recv_exact(s, n):
        """n bytes, or None once the server has closed the connection."""
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = s.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    def client(port, frames, limit):
        deadline = time.time() + 120
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=120)
                break
            except OSError:
                check(time.time() < deadline, "SIBR client could not connect")
                time.sleep(0.01)
        with s:
            while len(frames) < limit:
                t0 = time.perf_counter()
                try:
                    s.sendall(len(msg).to_bytes(4, "little") + msg)
                except OSError:
                    break
                img = recv_exact(s, W * H * 3)
                vlen = recv_exact(s, 4) if img is not None else None
                if vlen is None:
                    break
                verify = recv_exact(s, int.from_bytes(vlen, "little"))
                frames.append((img, verify.decode("ascii"),
                               (time.perf_counter() - t0) * 1e3))

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    plain_step, plain_serve = trainer_mod.train_step, network_gui.serve_step
    timing = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            timing.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return res
        return run

    counters = path_wrappers()
    runs = {}
    for gui in (True, False):
        timing.clear()
        frames = []
        trainer_mod.train_step = timed("step", plain_step)
        network_gui.serve_step = timed("serve", plain_serve)
        for k in counters.values():
            k.launches = 0
        try:
            port = free_port()
            th = None
            if gui:
                th = threading.Thread(target=client,
                                      args=(port, frames, 10 ** 6))
                th.start()
            tr = gs_tools.gs_train(src, os.path.join(work, f"gui_{gui}"),
                                   iterations=iters, test_iterations=(),
                                   save_iterations=(iters,), quiet=True,
                                   gui=gui, port=port)
            if th is not None:
                th.join(timeout=120)
        finally:
            trainer_mod.train_step = plain_step
            network_gui.serve_step = plain_serve
        runs[gui] = dict(step=list(timing.get("step", [])),
                         serve=list(timing.get("serve", [])),
                         launches=read_launches(
                             counters, "gui" if gui else None),
                         frames=frames, trainer=tr)
    with_gui, without = runs[True], runs[False]
    frames = with_gui["frames"]
    check(tr.iteration == iters and with_gui["trainer"].iteration == iters,
          "GUI run trained its iterations")
    check(len(frames) >= iters - 1,
          f"{len(frames)} GUI frames over {iters} iterations")
    for img, verify, _ in frames:
        check(len(img) == W * H * 3 and verify == src,
              "GUI frame bytes / verify string")
    log(f"network GUI: {len(frames)} frames of {W}x{H} over {iters} "
        f"iterations, each {W * H * 3} bytes + the verify string; client ms "
        f"a frame median {np.median([f[2] for f in frames]):.2f}; "
        f"serve_step ms median {np.median(with_gui['serve']):.2f}; train "
        f"step ms median with the client {np.median(with_gui['step']):.2f}, "
        f"without {np.median(without['step']):.2f}; launches "
        f"{with_gui['launches']}")
    check(with_gui["launches"]["K1"] == iters + len(frames)
          and with_gui["launches"]["K3"] == iters,
          f"GUI run launches {with_gui['launches']} ({len(frames)} frames)")

    # The final model served once more, held to a direct render.
    final = with_gui["trainer"]
    gui_srv = network_gui.NetworkGUI("127.0.0.1", 0)
    last = []
    th = threading.Thread(target=client, args=(gui_srv.port, last, 1))
    th.start()
    seen = {}

    def render_fn(c, scaling):
        seen["cam"] = c
        return render_model(final.model.params, final.model.state.alive, c,
                            final.model.active_sh_degree,
                            torch.zeros(3, device="cuda"), final.rcfg,
                            scale_modifier=scaling).image

    for _ in range(24000):
        gui_srv.try_connect()
        if gui_srv.conn is not None:
            network_gui.serve_step(gui_srv, render_fn, iters, iters, src,
                                   device="cuda")
            break
        time.sleep(0.005)
    th.join(timeout=120)
    gui_srv.close()
    with torch.no_grad():
        ref = render_fn(seen["cam"], 1.0)
    check(len(last) == 1 and last[0][0] == network_gui.frame_bytes(ref),
          "final GUI frame equals a direct render of the final model")
    log("network GUI: the final model's frame equals a direct render")
    return with_gui["launches"], dict(
        frame_ms=[f[2] for f in frames], serve_ms=with_gui["serve"],
        step_ms_gui=with_gui["step"], step_ms=without["step"])


def phase_utils_viz(work, serving, stereo_dirs):
    """Phase 17: profile_trace around 3 renders (its Chrome trace must name
    K1's and K2's kernels), time_block on a render, and view_results_panel
    on phase 5b's stereo outputs of view 0 (the panel as wide as its five
    images)."""
    from gs2mesh_torch import viz
    from gs2mesh_torch.core.png import read_png
    from gs2mesh_torch.pipeline import PipelineArgs
    from gs2mesh_torch.utils import profile_trace, time_block

    eargs = serving["eargs"]
    trace_dir = os.path.join(work, "trace")
    with torch.no_grad():
        with profile_trace(trace_dir):
            for _ in range(3):
                run_forward_kernels(eargs)
            torch.cuda.synchronize()
        with time_block("K1 + sort + K2 render", sync=eargs[0]) as tb:
            run_forward_kernels(eargs)
    (trace,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: any(v in n for n in names) for k, v in
             (("K1", OWN_KERNELS["K1"]), ("K2", OWN_KERNELS["K2"]))}
    size = os.path.getsize(os.path.join(trace_dir, trace))
    log(f"profile_trace: {trace} ({size} bytes) names K1 / K2: {found}; "
        f"time_block {tb['ms']:.3f} ms")
    check(all(found.values()), f"trace kernel names {found}")
    name = PipelineArgs.for_dataset("DTU").stereo_model   # phase 5b's
    panel = viz.view_results_panel(stereo_dirs[0], name,
                                   save_path=os.path.join(work, "panel.png"),
                                   rng=np.random.default_rng(0))
    files = ("left.png", "left_mask.png", f"out_{name}/disparity_LR.png",
             f"out_{name}/occlusion_mask.png", f"out_{name}/shading.png")
    shapes = {f: read_png(os.path.join(stereo_dirs[0], f)).shape[:2]
              for f in files if os.path.exists(os.path.join(stereo_dirs[0],
                                                            f))}
    h, w = shapes["left.png"]
    width = sum(shapes.get(f, (h, w))[1] for f in files)
    log(f"view_results_panel on view 0: {panel.shape}, from the files "
        f"{shapes} (a missing one filled with seeded noise)")
    check(panel.shape == (h, width, 3) and width == 5 * w,
          f"panel {panel.shape}, widths sum to {width}")
    check(os.path.getsize(os.path.join(work, "panel.png")) > 1000,
          "panel.png")


# ---------------------------------------------------------------- phase 19
CALIBRATE_ITERS = 1500        # of the tool's 4000: densify 500-1000, 6 times
WALKTHROUGH_ITERS = 40        # GS_iterations of the walkthrough
# The walkthrough's plotting calls: matplotlib or plotly, which the card's
# machine lacks.
PLOT_CALLS = ("visualize_poses", "visualize_mesh")


def load_script(folder, name):
    """<folder>/<name>.py beside this script as a module (the tools import
    each other by name)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), folder)
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


def log_record(what, rec):
    windows = [(w["iterations"], round(w["median_ms"], 3),
                w["device_busy_ms"] and round(w["device_busy_ms"], 3),
                w["device_events"], w["alive_end"])
               for w in rec["step_ms_windows"]]
    log(f"{what}: {rec['taken_steps']} taken steps in {rec['wall_s']:.2f} s "
        f"(and {rec['profile_s']:.2f} s starting and reading profiles); step "
        f"ms median, device busy ms, device events a step, alive by window "
        f"{windows}; densifies "
        f"{rec['densifies']}; model grew {rec['capacity_grows']}x, pair "
        f"capacity {rec['pair_capacity_grows']}x; launches "
        f"{rec['launches']}; peak {rec['peak_memory_gib']:.3f} GiB")


def check_launches(what, launches, steps, renders):
    """K1 / K2 once per render (taken steps, overflowed attempts and other
    renders), K3 / K4 once per taken step."""
    want = {"K1": renders, "K2": renders, "K3": steps, "K4": steps}
    log(f"{what} launches {launches} (implied {want})")
    check(launches == want, f"{what} launches {launches} != {want}")


def trained_step_vs_plain(tr, what):
    """One training step's K1-K4 against their plain versions on a
    trainer's state as training left it: its params and alive mask at the
    capacity it grew to (the dead rows that pruning and growth leave
    included), its pair capacity, the active SH degree, view 0's camera and
    target, and the cotangent of the training loss (gs_loss on the step's
    background) at that view (step_vs_plain). Returns the max abs error by
    kernel."""
    errs, _ = step_vs_plain(tr.model, tr.cameras[0], tr.rcfg,
                            tr.model.active_sh_degree, tr._image_dev(0),
                            tr._bg(), tr.cfg.lambda_dssim, what)
    return errs


def step_vs_plain(m, cam, cfg, sh_degree, target, bg, lambda_dssim, what):
    """One training step's K1-K4 against their plain versions on a model's
    params and alive mask, at a camera, pair capacity (``cfg``) and SH
    degree, with the cotangent of the training loss (gs_loss against
    ``target`` on ``bg``). Phase 3's limits: K1 bit for bit, K2 2e-5 on
    >= 99.99% of the values, K3 and K4 as compare_backward holds them.
    Returns the max abs error by kernel and (the pair count, the plain
    compositor's accepted (pair, pixel))."""
    from gs2mesh_torch.models.gaussians import activations
    from gs2mesh_torch.ops.rasterizer.composite import composite_cuda
    from gs2mesh_torch.ops.rasterizer.emit import (build_feat9,
                                                   emission_cuda,
                                                   emission_plain)
    from gs2mesh_torch.ops.rasterizer.preprocess import preprocess
    from gs2mesh_torch.ops.rasterizer.tile_render import (
        composite_plain, pair_box_mask_plain, pair_rows)
    from gs2mesh_torch.ops.ssim import gs_loss

    W, H = cam.width, cam.height
    gx, gy = cfg.grid_size(W, H)
    with torch.no_grad():
        inp = activations(m.params, m.state.alive)
        prep = preprocess(inp["means3d"], inp["scales"], inp["rotations"],
                          inp["opacities"], inp["shs"], cam, sh_degree, cfg)
        feat9 = build_feat9(prep)
        eargs = (feat9, prep.depths, prep.rect, prep.tiles_touched, W, H, cfg)
        pairs, k1_err = compare_emission(emission_cuda(*eargs),
                                         emission_plain(*eargs), gx * gy,
                                         what)
        check(not bool(pairs.overflow), f"{what}: pair overflow")
        color, final_T = composite_cuda(pairs.ids, pairs.tile_starts,
                                        pairs.tile_counts, feat9, W, H, cfg)
        rows = pair_rows(feat9, pairs.ids)
        plain = composite_plain(
            rows, pairs.tile_starts, pairs.tile_counts, W, H, cfg,
            int(pairs.tile_counts.max()), box_mask=pair_box_mask_plain(
                rows, pairs.tile_starts, pairs.tile_counts, W, H, cfg))
        k2_err = compare_composite(color, final_T, plain.color, plain.final_T,
                                   what)
        accepted = int(plain.n_accepted)
        del rows, plain
    image = (color + final_T[None] * bg[:, None, None]).requires_grad_(True)
    (dC,) = torch.autograd.grad(gs_loss(image, target, lambda_dssim), image)
    dT = (dC * bg[:, None, None]).sum(0)
    with torch.no_grad():
        k3, k4 = run_backward_kernels(pairs, feat9, prep.tiles_touched, color,
                                      final_T, dC, dT, W, H, cfg)
        plain3 = run_backward_plain(pairs, feat9, dC, dT, W, H, cfg)
        k3_err, k4_err = compare_backward(k3, k4, plain3, pairs,
                                          prep.tiles_touched, what)
    shown = prep.radius > 0
    log(f"{what}: {W}x{H}: capacity {m.capacity} rows, "
        f"{int(m.alive.sum())} alive; on screen "
        f"{int((shown & m.alive).sum())} alive and "
        f"{int((shown & ~m.alive).sum())} dead rows (opacity 0), "
        f"which touch {int(prep.tiles_touched[~m.alive].sum())} tiles; "
        f"pair capacity {cfg.pair_capacity}, {int(pairs.num_pairs)} pairs, "
        f"{accepted} accepted (pair, pixel); SH degree {sh_degree}; max abs "
        f"err K1 {k1_err:.3e}, K2 {k2_err:.3e}, K3 {k3_err:.3e}, K4 "
        f"{k4_err:.3e}")
    return (dict(K1=k1_err, K2=k2_err, K3=k3_err, K4=k4_err),
            (int(pairs.num_pairs), accepted))


def phase_trainsmoke():
    """Phase 19 (a) and (b): tools/trainsmoke_chip_torch.py's 1,200
    iterations with its checks, then the forced-growth run on its scene;
    after each, one step's K1-K4 against their plain versions on the
    trained state. Returns K1-K4's launches over (a) and the max abs
    errors of (a) and (b)."""

    ts = load_script("tools", "trainsmoke_chip_torch")
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    tr, res = ts.run()           # prints its dict; raises on a failed check
    # The targets are render_golden's: a preprocess each and no K1.
    launches = read_launches(counters, "trainsmoke",
                             p1_outside=len(tr.images))
    log(f"19a trainsmoke_chip_torch.run(): {time.perf_counter() - t0:.2f} s")
    log_record("19a trainsmoke", res)
    check_launches("19a trainsmoke", launches, res["taken_steps"],
                   res["taken_steps"] + res["pair_capacity_grows"])
    check(res["launches"] == launches, "19a launches all in training")
    check(res["taken_steps"] == res["iterations"] == 1200, "1200 steps")
    check(not res["over_capacity_steps"], "19a steps over pair capacity")
    errs = dict(trainsmoke=trained_step_vs_plain(tr, "19a trained step"))

    t0 = time.perf_counter()
    scene = ts.sphere_scene(n=4000, seed=2)
    cams, images = tr.cameras, tr.images
    del tr
    tr, rec = ts.forced_growth(scene, cams, images)
    torch.cuda.synchronize()
    log(f"19b forced growth: {time.perf_counter() - t0:.2f} s; first render "
        f"{rec['first_pairs']} pairs, pair capacity "
        f"{rec['pair_capacity_start']} -> {rec['pair_capacity_final']}, "
        f"model capacity {rec['model_capacity_start']} -> "
        f"{rec['model_capacity_final']}, alive {rec['alive_final']}")
    log_record("19b forced growth", rec)
    check(rec["taken_steps"] == tr.iteration == ts.FORCED_ITERS,
          f"19b {ts.FORCED_ITERS} taken steps")
    check(rec["capacity_grows"] >= 1, "19b grow_capacity fired")
    check(rec["pair_capacity_grows"] >= 1, "19b pair-overflow redo fired")
    check(not rec["over_capacity_steps"], "19b steps over pair capacity")
    check(rec["params_finite"] and all(map(math.isfinite, rec["losses"])),
          "19b finite params and losses")
    check_launches("19b forced growth", rec["launches"], rec["taken_steps"],
                   rec["taken_steps"] + rec["pair_capacity_grows"])
    errs["forced_growth"] = trained_step_vs_plain(tr, "19b grown step")
    return launches, errs


def phase_calibrate():
    """Phase 19 (c): tools/calibrate_scene_torch.py at full width (24 ring
    views of the 300k bench sphere at 960x576, a 30k-point init, capacity
    2^19, pair capacity 2^22), cut to CALIBRATE_ITERS iterations; then one
    step's K1-K4 against their plain versions on the trained state (after
    the last densify). Returns K1-K4's launches over the tool, the max abs
    errors and the trainer (phase 20 (a) carries it on)."""

    cal = load_script("tools", "calibrate_scene_torch")
    iters = CALIBRATE_ITERS
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    tr, res = cal.run(iters)
    # The tool's statistics of the trained model preprocess once more.
    launches = read_launches(counters, "calibrate", p1_outside=1)
    n_densify = len(range(500, iters - 500 + 1, 100))
    log(f"19c calibrate_scene_torch.run({iters}) (cut from the tool's 4000 "
        f"to fit the smoke: densify 500-{iters - 500}, {n_densify} times): "
        f"{time.perf_counter() - t0:.2f} s")
    log_record("19c calibrate", res)
    steps = res["taken_steps"]
    # 24 ground-truth renders, the steps and their redos, the bench camera
    # and the PSNR view.
    check_launches("19c calibrate", launches, steps,
                   cal.N_RING + steps + res["pair_capacity_grows"] + 2)
    check(steps == iters, f"19c {iters} taken steps")
    check(len(res["densifies"]) == n_densify, f"19c {n_densify} densifies")
    check(res["final_loss_ma50"] < res["first_loss"], "19c loss falls")
    check(res["alive_final"] > res["alive_start"], "19c alive rows grow")
    check(res["params_finite"], "19c finite params")
    check(not res["over_capacity_steps"], "19c steps over pair capacity")
    return launches, trained_step_vs_plain(tr, "19c trained step"), tr


def phase_walkthrough(work):
    """Phase 19 (d): the port's walkthrough, cell by cell, on a custom-layout
    copy of phase 6's scene (images/, sparse/0 with its text model as
    run_colmap leaves it), video and COLMAP skipped, WALKTHROUGH_ITERS GS
    iterations, a seeded DLNR at checkpoints/<stereo_model>.pth (the
    released layout), masking off; the three plotting calls left out. Then
    the sphere's analytic depth over every view and the TSDF cell again.
    Returns K1-K4's launches over the cells."""
    from gs2mesh_torch.core import colmap_io
    from gs2mesh_torch.core.ply import read_ply
    from gs2mesh_torch.pipeline import PipelineArgs
    from gs2mesh_torch.stereo import DLNR, init_dlnr_

    wt = load_script("examples", "run_walkthrough_torch")
    iters = WALKTHROUGH_ITERS
    base = os.path.join(work, "walkthrough")
    scene = os.path.join(base, "data", "custom", "sculpture")
    shutil.copytree(os.path.join(work, "train_scene"), scene)
    colmap_io.convert_bin_to_text(os.path.join(scene, "sparse", "0"))
    os.makedirs(os.path.join(base, "checkpoints"))
    name = PipelineArgs.for_dataset("custom").stereo_model
    dlnr = init_dlnr_(DLNR(), torch.Generator().manual_seed(0))
    torch.save({"module." + k: v for k, v in dlnr.state_dict().items()},
               os.path.join(base, "checkpoints", f"{name}.pth"))
    params = dict(device="cuda", skip_video_extraction=True,
                  skip_colmap=True, GS_iterations=iters,
                  GS_save_test_iterations=[iters], masker_automask=False)
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    ns, walls, skipped = wt.run_walkthrough(base, params, skip=PLOT_CALLS)
    launches = read_launches(counters, "walkthrough")
    log(f"19d walkthrough ({wt.WALKTHROUGH}) calls left out (no matplotlib "
        f"or plotly on this machine): {skipped}")
    for title, s in walls.items():
        log(f"19d cell {title!r}: {s:.3f} s")
    check(len(skipped) == 3, f"19d left out {skipped}")
    tr, renderer = ns["trainer"], ns["renderer"]
    n_views = len(renderer)
    redos = int(round(math.log2(tr.rcfg.pair_capacity / (1 << 22))))
    # The training steps and their redos, report_psnr's 4 views, the
    # overlap cell's pair and 2 renders a stereo view.
    check_launches("19d walkthrough", launches, iters,
                   iters + redos + 4 + 2 + 2 * n_views)
    panel = ns["panel"]
    log(f"19d panel {panel.shape} {panel.dtype}; views {n_views}, pair "
        f"capacity redos {redos}")
    check(panel.ndim == 3 and panel.shape[2] == 3 and panel.dtype == np.uint8,
          f"19d panel {panel.shape} {panel.dtype}")
    path = ns["clean_path"]
    check(os.path.exists(path), "19d cleaned mesh written")
    # A random DLNR's depth is no surface: custom cleaning (parts under
    # 100k faces go) may leave nothing, so the vertex check is the
    # analytic pass's below.
    log(f"19d on the random DLNR's depth: mesh "
        f"{len(ns['tsdf'].mesh.vertices)} vertices, cleaned "
        f"{len(read_ply(path).positions)} ({path})")

    # The sphere's analytic depth over every view, then the TSDF cell again.
    for i, cam in enumerate(renderer.left_cameras):
        K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                      [0, 0, 1.0]])
        E = np.linalg.inv(np.asarray(cam["extrinsic"], np.float64))
        depth = sphere_depth(K, E, cam["width"], cam["height"])
        out = os.path.join(renderer.render_folder_name(i), f"out_{name}")
        np.save(os.path.join(out, "depth.npy"), depth)
        np.save(os.path.join(out, "occlusion_mask.npy"),
                np.ones(depth.shape, bool))
    (tsdf_cell,) = [c for c in wt.walkthrough_cells()
                    if c[0].startswith("TSDF")]
    t0 = time.perf_counter()
    wt.run_cell(ns, *tsdf_cell)
    rad = np.linalg.norm(read_ply(ns["clean_path"]).positions, axis=1)
    voxel = ns["args"].TSDF_voxel / 512.0
    med = float(np.median(np.abs(rad - 1.0)))
    log(f"19d TSDF cell on the analytic depth: {time.perf_counter() - t0:.3f}"
        f" s, {len(rad)} cleaned vertices, median | |v| - 1 | {med:.5f} "
        f"(voxel {voxel:.5f})")
    check(len(rad) > 1000 and med < 2 * voxel,
          "19d cleaned mesh on the analytic depth")
    return launches



# ---------------------------------------------------------------- phase 20
SIZE_PRUNE_RESET = 3000       # 20 (a): the reset the size prune follows
SCALE_START, SCALE_END = 200, 500   # 20 (b): the schedule's iterations 201-500


def phase_size_prune(tr):
    """Phase 20 (a): 19c's calibrate trainer carried on as the schedule
    does past its first opacity reset (iteration SIZE_PRUNE_RESET: the
    reset, then iterations 3,001-3,100 with the densify at 3,100, where
    Trainer.densify turns the size prune on). The densify's prune removes
    exactly the alive rows under the opacity cull or over a tenth of the
    scene extent in the world, and none for its screen size: every alive
    row over 20 px on screen (JAX's rule would remove them; there must be
    some, and they are printed) that passes both tests is kept, and
    max_radii2D comes back zero. Returns K1-K4's launches over the 100
    steps."""

    it = SIZE_PRUNE_RESET
    tr.cfg = dataclasses.replace(tr.cfg, iterations=it + 100,
                                 densify_until_iter=it + 100,
                                 opacity_reset_interval=it)
    tr.iteration = it
    tr.reset_opacity()
    seen = {}
    densify = tr.densify

    def watched():
        st, p = tr.model.state, tr.model.params
        alive = st.alive.clone()
        seen.update(
            iteration=tr.iteration, alive=alive,
            opacity=alive & (torch.sigmoid(p.opacity[:, 0]) < 0.005),
            world=alive & (torch.exp(p.scaling).amax(1)
                           > 0.1 * tr.scene_extent),
            screen=alive & (st.max_radii2D > 20.0))
        seen["stats"] = densify()
        seen["after"] = tr.model.state.alive.clone()
        return seen["stats"]

    tr.densify = watched
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    losses = []
    t0 = time.perf_counter()
    pcap = tr.rcfg.pair_capacity
    tr.train(100, callback=lambda t, out: losses.append(float(out.loss)))
    torch.cuda.synchronize()
    launches = read_launches(counters, "size_prune")
    del tr.densify
    alive, after = seen["alive"], seen["after"]
    opacity, world, screen = seen["opacity"], seen["world"], seen["screen"]
    n_prune = seen["stats"]["n_prune"]
    by_size = screen & ~opacity & ~world
    # A growth after the densify appends dead rows: the old rows keep
    # their slots.
    n = {k: int(v.sum()) for k, v in dict(
        alive_before=alive, alive_after=after, opacity=opacity, world=world,
        union=opacity | world, jax_screen=screen, screen_only=by_size,
        screen_only_kept=by_size & after[:alive.shape[0]],
        jax_would_keep=alive & ~(opacity | world | screen)).items()}
    log(f"20a size prune at {seen['iteration']} "
        f"({time.perf_counter() - t0:.2f} s for 100 steps after the reset "
        f"at {it}): alive {n['alive_before']}"
        f" -> {n['alive_after']}; candidates opacity {n['opacity']}, world "
        f"size {n['world']} (either {n['union']}); pruned {n_prune}; rows over"
        f" 20 px on screen that JAX's rule removes {n['jax_screen']} (over 20"
        f" px only: {n['screen_only']}, kept {n['screen_only_kept']}); JAX's "
        f"rule would keep {n['jax_would_keep']}; densify stats "
        f"{seen['stats']}; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(seen["iteration"] == it + 100, "20a densify at 3100")
    check(tr.iteration == it + 100 and len(losses) == 100, "20a 100 steps")
    check(n["jax_screen"] > 0, "20a rows over 20 px for JAX's rule")
    check(n_prune == n["union"], "20a prunes the opacity and world-size "
          "candidates only")
    check(n["screen_only_kept"] == n["screen_only"],
          "20a rows over 20 px kept")
    check(n["alive_after"] >= n["alive_before"] - n["opacity"] - n["world"],
          "20a alive after the densify")
    check(not tr.model.state.max_radii2D.any(), "20a max_radii2D zeroed")
    check(all(map(math.isfinite, losses)), "20a finite losses")
    check(all(bool(torch.isfinite(t).all())
              for t in tr.model.params.tensors()), "20a finite params")
    redos = int(round(math.log2(tr.rcfg.pair_capacity / pcap)))
    check_launches("20a size prune", launches, 100, 100 + redos)
    return launches


def phase_train_scale(work):
    """Phase 20 (b): tools/train_scale_torch.py's dense scene at full size
    (1M ground-truth splats, 64 training and 8 held-out views at 960x576,
    the binary COLMAP model with 50,000 points), the GS stage's trainer on
    it (pipeline.run_single.gs_trainer), the schedule's iterations
    SCALE_START + 1 to SCALE_END (the first densify, at 500, among them)
    recorded by train_recorded in 100-iteration windows; then one step's
    K1-K4 against their plain versions on that state. Returns K1-K4's
    launches (the 72 ground-truth renders, the steps and their redos) and
    the max abs errors."""

    ts = load_script("tools", "train_scale_torch")
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    root = os.path.join(work, "train_scale")
    scene = ts.write_scene(root, device="cuda")
    n_views = len(scene["gt_pairs"]["images"]) + len(
        scene["gt_pairs"]["heldout"])
    log(f"20b dense scene: {ts.N_GAUSS} splats, {n_views} views written in "
        f"{scene['scene_s']:.2f} s; ground-truth pairs a training view "
        f"{min(scene['gt_pairs']['images'])}-"
        f"{max(scene['gt_pairs']['images'])}; extent "
        f"{scene['scene_extent']:.4f}")
    t0 = time.perf_counter()
    tr = ts.gs_trainer(root, SCALE_END, white_background=False,
                       device="cuda")
    log(f"20b gs_trainer: {time.perf_counter() - t0:.2f} s, "
        f"{tr.num_alive()} rows of {tr.capacity}, {len(tr.cameras)} views")
    tr.iteration = SCALE_START
    steps = SCALE_END - SCALE_START
    rec = ts.smoke.train_recorded(tr, steps, window=100)
    log_record("20b dense scene", rec)
    launches = read_launches(counters, "train_scale")
    losses = rec["losses"]
    check(rec["taken_steps"] == steps and tr.iteration == SCALE_END,
          f"20b {steps} taken steps")
    check([d["iteration"] for d in rec["densifies"]] == [SCALE_END],
          "20b the densify at 500")
    check(rec["densifies"][0]["alive_after"]
          > rec["densifies"][0]["alive_before"], "20b densify grew the model")
    check(not rec["over_capacity_steps"], "20b steps over pair capacity")
    check(np.mean(losses[-50:]) < np.mean(losses[:50]), "20b loss falls")
    check(ts.smoke.params_finite(tr.model), "20b finite params")
    check_launches("20b dense scene", launches, steps,
                   n_views + steps + rec["pair_capacity_grows"])
    return launches, trained_step_vs_plain(tr, "20b dense scene step")


def phase_bench_cells():
    """Phase 21: the benchmark cells' workloads held to what
    bench_cells/counts.py and bench_cells/reference.py commit. The training
    cell's model, camera and target on the card: its step-0 K1-K4 against
    their plain versions at the cell's pair capacity (step_vs_plain), the
    plain emission's pair count and the plain compositor's accepted count
    equal to the committed ones; then one step of the cell's own step
    function through K1-K4 (each launched once), whose pair count is the
    committed one and whose loss is the reference's step-0 loss within the
    cell's limit. Then one view of the stereo cell: the refinement gate's
    outcome is the committed one and the disparity is within the cell's
    limit of the float64 reference. P1 and P2 against their plain versions
    on the cell's model at its loss cotangent, timed
    (phase_preprocess_vs_plain). Returns K1-K4's launches in the cell's
    step, the max abs errors against the plain versions (P1 and P2's too)
    and P1 and P2's rows of the kernels line."""
    from bench_cells import counts, reference, stereo_view, train_step
    from gs2mesh_torch.models.gaussians import activations
    from gs2mesh_torch.ops.ssim import gs_loss

    c, ref = counts.TRAIN_CELL, reference.load()
    t0 = time.perf_counter()
    s = train_step.setup(c, "cuda")
    errs, (pairs, accepted) = step_vs_plain(
        s.model, s.camera, s.rcfg, c["sh_degree"], s.target, s.bg,
        s.cfg.lambda_dssim, "21 training cell step 0")
    log(f"21 training cell, step 0 against the plain path: {pairs} pairs, "
        f"{accepted} accepted (pair, pixel) (committed {c['pairs']}, "
        f"{c['accepted']}); {time.perf_counter() - t0:.1f} s")
    check(pairs == c["pairs"], "21 plain pairs == committed")
    check(accepted == c["accepted"], "21 accepted == committed")
    bg, target = s.bg, s.target
    prep_errs, prep_rows = phase_preprocess_vs_plain(
        "21 training cell step 0",
        activations(s.model.params, s.model.state.alive), s.camera,
        c["sh_degree"], s.rcfg,
        lambda color, T: gs_loss(color + T[None] * bg[:, None, None], target,
                                 s.cfg.lambda_dssim), timed=True)
    errs.update(prep_errs)
    counters = path_wrappers()
    for k in counters.values():
        k.launches = 0
    out = s.step()
    launches = read_launches(counters, "bench_cells")
    loss, loss_ref = float(out.loss), float(ref["train.losses"][0])
    gap = abs(loss - loss_ref) / loss_ref
    log(f"21 training cell, one step through K1-K4: pairs "
        f"{int(out.num_pairs)}, loss {loss!r} (reference {loss_ref!r}, gap "
        f"{gap:.3e}, limit {c['loss_limit']:.3g}), launches {launches}")
    check(not (out.overflow or out.tile_overflow), "21 no overflow")
    check(int(out.num_pairs) == c["pairs"], "21 step pairs == committed")
    check(gap <= c["loss_limit"], "21 step-0 loss against the reference")
    check(all(v == 1 for v in launches.values()),
          "21 K1-K4 (and P1, P2) once each")
    del s, out
    sc = counts.STEREO_CELL
    model = stereo_view.seeded_dlnr("cuda")
    t0 = time.perf_counter()
    disp, refined = stereo_view.view_pass(
        model, *stereo_view.view_inputs(sc["height"], sc["width"], "cuda"),
        sc["iters"])
    gap = reference.disparity_gap(disp, ref)
    log(f"21 stereo cell, one view: refined {refined} (committed "
        f"{sc['refined']}), disparity gap to the float64 reference "
        f"{gap:.3e} (limit {sc['disparity_limit']:.3g}), "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    check(refined == sc["refined"], "21 stereo gate as committed")
    check(gap <= sc["disparity_limit"], "21 stereo disparity")
    return launches, errs, prep_rows


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
    from gs2mesh_torch.ops.rasterizer.preprocess import \
        preprocess_kernel_info
    for name, info in (("K1", emission_kernel_info()),
                       ("K2", kernel_info("K2")), ("K3", kernel_info("K3")),
                       ("P1", preprocess_kernel_info("P1")),
                       ("P2", preprocess_kernel_info("P2"))):
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
    narrow = phase_kernels_vs_plain(
        "60k narrow/360x200", 60_000, 360, 200, (0.006, 0.002), 10)
    phase_backward_vs_plain(*narrow)
    log(f"phase kernels-vs-plain: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    r, renders, launches = phase_main_path(work)
    p1_main = launches["preprocess"]
    log(f"phase main path: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows, dense, serving = phase_timings(r, launches)
    phase_profile(r)
    log(f"phase timings + profile: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    stereo = phase_stereo(r)
    for row, key in zip(rows, ("K1", "K2")):
        row["launches_stereo"] = stereo[key]
    PREP_LAUNCHES["stereo"] = {"P1": stereo["P1"], "P2": 0}
    log(f"phase stereo: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    from gs2mesh_torch.pipeline import PipelineArgs
    phase_tsdf(r, PipelineArgs.for_dataset("DTU").stereo_model)
    stereo_dirs = [r.render_folder_name(i) for i in range(2)]
    del r
    log(f"phase tsdf: {time.perf_counter() - t_phase:.1f} s")
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
    del trainer
    t_phase = time.perf_counter()
    pipe, pipe_tree = phase_pipeline(work)
    for row, key in zip(rows, ("K1", "K2", "K3", "K4")):
        row["launches_pipeline"] = pipe[key]
    log(f"phase pipeline: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_sam2_checks()
    phase_sam2_masker(work, pipe_tree)
    log(f"phase sam2: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    tools = phase_gs_tools(work)
    for row, key in zip(rows, ("K1", "K2", "K3", "K4")):
        row["launches_gs_tools"] = tools[key]
    log(f"phase gs tools: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_gdino_checks()
    phase_gdino(work, pipe_tree)
    log(f"phase gdino: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    strided_err = phase_strided_vs_plain(narrow)
    strided = phase_strided(serving)
    log(f"phase strided kernels: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    import torch.distributed as dist
    init_world_one(work)
    try:
        sharded, sharded_ms = phase_sharded_train(work)
        phase_sharded_inference([
            {side: os.path.join(d, f"{side}.png") for side in
             ("left", "right")} for d in stereo_dirs])
    finally:
        dist.destroy_process_group()
    log(f"phase sharded train + inference: "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    viewer, viewer_t = phase_viewer(work)
    log(f"phase viewer: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    gui, gui_t = phase_network_gui(work)
    log(f"phase network gui: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_utils_viz(work, serving, stereo_dirs)
    log(f"phase utils + viz: {time.perf_counter() - t_phase:.1f} s")
    sustained = {}
    t_phase = time.perf_counter()
    sustained["launches_trainsmoke"], trained_err = phase_trainsmoke()
    log(f"phase 19 trainsmoke: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sustained["launches_calibrate"], trained_err["calibrate"], cal_tr = \
        phase_calibrate()
    log(f"phase 19 calibrate: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sustained["launches_walkthrough"] = phase_walkthrough(work)
    log(f"phase 19 walkthrough: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sustained["launches_size_prune"] = phase_size_prune(cal_tr)
    del cal_tr
    log(f"phase 20 size prune: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sustained["launches_train_scale"], trained_err["train_scale"] = \
        phase_train_scale(work)
    log(f"phase 20 dense scene: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sustained["launches_bench_cells"], trained_err["bench_cells"], \
        prep_rows = phase_bench_cells()
    log(f"phase 21 bench cells: {time.perf_counter() - t_phase:.1f} s")
    for row, key in zip(rows, ("K1", "K2", "K3", "K4")):
        for name, launches in sustained.items():
            row[name] = launches[key]
        row["trained_vs_plain_max_abs_err"] = {
            path: err[key] for path, err in trained_err.items()}
        row["launches_viewer"] = viewer[key]
        row["launches_gui"] = gui[key]
        row["launches_sharded"] = sharded[key]
        if key != "K4":
            k = key.lower()
            row["strided"] = {str(G): dict(
                ms_per_slice=v["ms"][k], bound_ms_per_slice=v["bounds"][k],
                pairs_per_slice=v["pairs"], balance=v["balance"])
                for G, v in strided.items()}
            row["strided_vs_plain_max_abs_err"] = strided_err[k]
    rows[3]["strided_sum_max_abs_err"] = {
        str(G): v["grad_err"] for G, v in strided.items()}
    # P1's and P2's launches on each path that K1's and K3's rows report.
    for row, like, key in zip(prep_rows, (rows[0], rows[2]), ("P1", "P2")):
        row["launches"] = p1_main if key == "P1" \
            else PREP_LAUNCHES["train"]["P2"]
        row.update({f"launches_{path}": n[key]
                    for path, n in PREP_LAUNCHES.items()
                    if f"launches_{path}" in like})
        row["trained_vs_plain_max_abs_err"] = {
            "bench_cells": trained_err["bench_cells"][key]}
    rows += prep_rows
    log(f"viewer request ms median {np.median(viewer_t['request_ms']):.2f}; "
        f"GUI frame ms median {np.median(gui_t['frame_ms']):.2f}; step ms "
        f"Trainer {sharded_ms['trainer_ms']:.2f} / ShardedTrainer "
        f"{sharded_ms['sharded_ms']:.2f}")
    shutil.rmtree(work)

    # The card again, so that the end of a long log carries it beside the
    # numbers above.
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
