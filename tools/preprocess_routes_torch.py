#!/usr/bin/env python3
"""chip_smoke.py's phase-8 training through three preprocess routes, and
the view-0 GroundingDINO box that each route's render leads to.

Phase 8 trains 40 steps at 300k gaussians on a DTU-layout sphere scan (8
views at 1554x1162) through ``run_single`` and renders the stereo views.
Phase 11 asks a seeded SwinT-OGC GroundingDINO for its best box on the
view-0 render. This script writes that scan once and runs ``run_single``
(masks and TSDF skipped) once a route, in a directory of its own:

  kernels    P1 / P2, as ``preprocess`` routes CUDA tensors. Every P2
             launch is also held to autograd of ``preprocess_plain`` at
             the same inputs and cotangents, in float32 and in float64.
             Run twice, to show that the route repeats bit for bit.
  plain      ``preprocess_plain``, differentiated by autograd in float32:
             the route before the kernels.
  plain_f64  ``preprocess_plain``'s float32 outputs, with the gradient that
             autograd gives in float64, rounded to float32: a gradient
             closer to the exact one than either of the others.
  plain_scan the plain route on a second scan whose target images were
             also rendered through ``preprocess_plain`` (the first scan's
             go through P1, whose rgb may round apart in the last bit):
             the preprocess of a tree without the kernels, end to end.

Prints, per P2 launch, its largest gap to autograd float32 and float64
and autograd float32's own gap to float64, each over its column's largest
magnitude; per pair of routes, the largest step-loss gap and the largest
gap of each trained parameter group; per route, the three best
GroundingDINO queries on view 0 (score, box in pixels) and
``best_box_xyxy``'s box. The JSON goes to ``--out`` too.

    python3 tools/preprocess_routes_torch.py [--out FILE]
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CAPTION = "main_object"          # SAM2Masker's default prompt (phase 11)
ROUTES = ("kernels", "kernels_again", "plain", "plain_f64", "plain_scan")
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def as_float64(camera):
    return dataclasses.replace(camera, **{
        f.name: getattr(camera, f.name).double()
        for f in dataclasses.fields(camera)
        if torch.is_tensor(getattr(camera, f.name))})


def plain_grads(x, camera, sh_degree, cfg, scale_modifier, cot, dtype):
    """Autograd of preprocess_plain's means2d, conic and rgb at ``cot``, in
    ``dtype``; x = (means3d, scales, rotations, shs)."""
    from gs2mesh_torch.ops.rasterizer import preprocess as pp

    cam = camera if dtype == torch.float32 else as_float64(camera)
    with torch.enable_grad():
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in x]
        ones = torch.ones(x[0].shape[0], dtype=dtype, device=x[0].device)
        out = pp.preprocess_plain(leaves[0], leaves[1], leaves[2], ones,
                                  leaves[3], cam, sh_degree, cfg,
                                  scale_modifier, float_type=dtype)
        g = torch.autograd.grad((out.means2d, out.conic, out.rgb), leaves,
                                [c.to(dtype) for c in cot],
                                allow_unused=True)
    return [torch.zeros_like(t) if a is None else a
            for a, t in zip(g, leaves)]


def column_gap(a, b):
    """The largest |a - b| over its column's largest |b|, over the four
    gradient groups."""
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.double().reshape(x.shape[0], -1), y.double().reshape(
            y.shape[0], -1)
        scale = y.abs().amax(0).clamp_min(1e-30)
        worst = max(worst, float(((x - y).abs() / scale).max()))
    return worst


class F64Grad(torch.autograd.Function):
    """preprocess_plain's float32 outputs, differentiated in float64."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, shs, camera,
                sh_degree, cfg, scale_modifier):
        from gs2mesh_torch.ops.rasterizer import preprocess as pp

        o = pp.preprocess_plain(means3d, scales, rotations, opacities, shs,
                                camera, sh_degree, cfg, scale_modifier)
        ctx.save_for_backward(means3d, scales, rotations, shs)
        ctx.args = (camera, sh_degree, cfg, scale_modifier)
        ctx.mark_non_differentiable(o.depths, o.radius, o.rect,
                                    o.tiles_touched)
        return (o.means2d, o.depths, o.conic, o.rgb, o.radius, o.rect,
                o.tiles_touched)

    @staticmethod
    def backward(ctx, dmeans2d, _depths, dconic, drgb, *_ints):
        g = plain_grads(ctx.saved_tensors, *ctx.args,
                        (dmeans2d, dconic, drgb), torch.float64)
        g = [t.float() for t in g]
        return g[0], g[1], g[2], None, g[3], None, None, None, None


def fused_f64(means3d, scales, rotations, opacities, shs, camera, sh_degree,
              cfg, scale_modifier=1.0):
    from gs2mesh_torch.ops.rasterizer.preprocess import Preprocessed

    n = means3d.shape[0]
    op_n = opacities.reshape(n).float()
    o = F64Grad.apply(means3d.float(), scales.float(), rotations.float(),
                      op_n, shs.float(), camera, sh_degree, cfg,
                      float(scale_modifier))
    return Preprocessed(means2d=o[0], depths=o[1], conic=o[2], rgb=o[3],
                        opacity=op_n, radius=o[4], rect=o[5],
                        tiles_touched=o[6])


def run_route(route, scan_base, work, p2_gaps):
    """run_single's pass 1 of phase 8 through ``route``; returns the step
    losses, the trained parameters on the host and view 0's left.png."""
    import chip_smoke as cs
    from gs2mesh_torch.ops.rasterizer import preprocess as pp
    from gs2mesh_torch.pipeline import PipelineArgs
    from gs2mesh_torch.pipeline import run_single as rs
    from gs2mesh_torch.sam2.predictor import read_frame
    from gs2mesh_torch.stereo import DLNR, init_dlnr_
    from gs2mesh_torch.train.trainer import Trainer

    base = os.path.join(work, route)
    shutil.copytree(scan_base, base)
    cfg = cs.PIPE
    name = f"scan{cfg['scan']}"
    args = PipelineArgs.for_dataset(
        "DTU", colmap_name=name, GS_iterations=cfg["iters"],
        GS_save_test_iterations=[cfg["iters"]], skip_masking=True,
        skip_TSDF=True)
    dlnr = init_dlnr_(DLNR(), torch.Generator().manual_seed(0))
    losses, trainers = [], []
    plain_step, plain_train = Trainer._step, rs.train_gs
    plain_fused = pp.preprocess_fused

    def step(self, views, sh_degree):
        out = plain_step(self, views, sh_degree)
        losses.append(out.loss)
        return out

    def train_gs(*a, **kw):
        trainers.append(plain_train(*a, **kw))
        return trainers[-1]

    plain_backward = pp.PreprocessFunction.backward

    def checked_backward(ctx, dmeans2d, ddepths, dconic, drgb, *dints):
        g = plain_backward(ctx, dmeans2d, ddepths, dconic, drgb, *dints)
        g = (g[0], g[1], g[2], g[4])
        x, args = ctx.saved_tensors, ctx.args
        a32, a64 = (plain_grads(x, *args, (dmeans2d, dconic, drgb), dt)
                    for dt in (torch.float32, torch.float64))
        p2_gaps.append(dict(p2_vs_autograd32=column_gap(g, a32),
                            p2_vs_autograd64=column_gap(g, a64),
                            autograd32_vs_64=column_gap(a32, a64)))
        return g[0], g[1], g[2], None, g[3], None, None, None, None

    launched = {k: w.launches for k, w in cs.path_wrappers().items()}
    Trainer._step, rs.train_gs = step, train_gs
    if route == "kernels":
        pp.PreprocessFunction.backward = staticmethod(checked_backward)
    elif route in ("plain", "plain_scan"):
        pp.preprocess_fused = pp.preprocess_plain
    elif route == "plain_f64":
        pp.preprocess_fused = fused_f64
    try:
        rs.run_single(args, base_dir=base, stereo_model=dlnr, device="cuda")
        torch.cuda.synchronize()
    finally:
        Trainer._step, rs.train_gs = plain_step, plain_train
        pp.preprocess_fused = plain_fused
        pp.PreprocessFunction.backward = staticmethod(plain_backward)
    launched = {k: w.launches - launched[k]
                for k, w in cs.path_wrappers().items()}
    (tr,) = trainers
    alive = tr.model.alive
    params = {k: getattr(tr.model.params, k).detach() for k in PARAMS}
    if alive is not None:
        params = {k: v[alive] for k, v in params.items()}
    params = {k: v.cpu() for k, v in params.items()}
    left = [os.path.join(dp, "left.png") for dp, _, fs in os.walk(base)
            if "left.png" in fs and os.path.basename(dp) == "000"]
    cs.check(len(left) == 1, f"{route}: one view-0 left.png ({left})")
    return dict(losses=torch.stack(losses).cpu().numpy(), params=params,
                frame=read_frame(left[0]), launches=launched)


def target_gap(scan_a, scan_b):
    """Pixels whose colour differs between two scans' target images, a
    view."""
    from gs2mesh_torch.core.png import read_png

    images = [os.path.join("data", "DTU", dp, "images") for dp in
              os.listdir(os.path.join(scan_a, "data", "DTU"))
              if dp.startswith("scan")]
    (folder,) = images
    names = sorted(os.listdir(os.path.join(scan_a, folder)))
    return [int((read_png(os.path.join(scan_a, folder, n))
                 != read_png(os.path.join(scan_b, folder, n))).reshape(
                     -1, 3).any(-1).sum()) for n in names]


def top_queries(net, tokenizer, frame, k=3):
    """The k best queries of ``predict`` on ``frame`` (its score, the raw
    logit it comes from, its box in pixels) and best_box_xyxy's box."""
    from gs2mesh_torch.core.precision import precision_scope
    from gs2mesh_torch.gdino import (best_box_xyxy, gdino_forward,
                                     prepare_text_inputs, predict)
    from gs2mesh_torch.gdino.inference import (preprocess_caption,
                                               preprocess_image)

    boxes, scores, _ = predict(net, frame, caption=CAPTION,
                               box_threshold=0.0, tokenizer=tokenizer)
    ids = np.asarray(tokenizer(preprocess_caption(CAPTION))["input_ids"],
                     np.int64)
    with torch.no_grad(), precision_scope():
        out = gdino_forward(net, preprocess_image(frame, "cuda"),
                            *prepare_text_inputs(ids, net.cfg, "cuda"))
    logits = out["pred_logits"][0].amax(1).double().cpu().numpy()
    h, w = frame.shape[:2]
    order = np.argsort(-scores, kind="stable")[:k]
    rows = []
    for q in order:
        cx, cy, bw, bh = boxes[q] * np.array([w, h, w, h])
        rows.append(dict(query=int(q), score=float(scores[q]),
                         logit=float(logits[q]),
                         box=[float(cx - bw / 2), float(cy - bh / 2),
                              float(cx + bw / 2), float(cy + bh / 2)]))
    best = best_box_xyxy(boxes, scores, (h, w))
    return rows, [float(v) for v in best]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "preprocess_routes.json"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("preprocess_routes_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bench_cells.measure import card_line
    from gs2mesh_torch.gdino import GDINOConfig, load_tokenizer
    from gs2mesh_torch.ops.rasterizer import preprocess as pp

    print(card_line("cuda"), flush=True)
    res = dict(card=card_line("cuda"))
    with tempfile.TemporaryDirectory() as work:
        scans = {s: os.path.join(work, f"scan_{s}") for s in ("p1", "plain")}
        cs.write_dtu_scan(scans["p1"], cs.PIPE)
        plain_fused = pp.preprocess_fused
        pp.preprocess_fused = pp.preprocess_plain
        try:
            cs.write_dtu_scan(scans["plain"], cs.PIPE)
        finally:
            pp.preprocess_fused = plain_fused
        res["target_pixels_differ"] = target_gap(*scans.values())
        print(f"scan targets, P1 against plain: pixels that differ a view "
              f"{res['target_pixels_differ']}", flush=True)
        runs, p2_gaps = {}, []
        for route in ROUTES:
            runs[route] = run_route(
                route, scans["plain" if route == "plain_scan" else "p1"],
                work, p2_gaps if route == "kernels" else [])
            print(f"{route}: launches {runs[route]['launches']}; losses "
                  f"{runs[route]['losses'][[0, -1]].tolist()}", flush=True)
        res["launches"] = {r: runs[r]["launches"] for r in ROUTES}
        res["p2_steps"] = len(p2_gaps)
        res["p2_worst"] = {k: max(g[k] for g in p2_gaps)
                           for k in p2_gaps[0]}
        res["p2_median"] = {k: float(np.median([g[k] for g in p2_gaps]))
                            for k in p2_gaps[0]}
        print(f"P2 over {len(p2_gaps)} launches, the largest gap over its "
              f"column's largest magnitude: worst {res['p2_worst']}, median "
              f"{res['p2_median']}", flush=True)

        gaps = {}
        for i, r1 in enumerate(ROUTES):
            for r2 in ROUTES[i + 1:]:
                x, y = runs[r1], runs[r2]
                same_rows = all(x["params"][k].shape == y["params"][k].shape
                                for k in PARAMS)
                g = dict(loss=float(np.abs(x["losses"].astype(np.float64)
                                           - y["losses"]).max()),
                         frame_pixels_differ=int(
                             (x["frame"] != y["frame"]).any(-1).sum()))
                if same_rows:
                    g.update({k: float((x["params"][k].double()
                                        - y["params"][k].double()).abs()
                                       .max()) for k in PARAMS})
                gaps[f"{r1} vs {r2}"] = g
                print(f"{r1} vs {r2}: {g}", flush=True)
        res["gaps"] = gaps

        net = cs.gdino_seeded(GDINOConfig()).to("cuda")
        tok = load_tokenizer(cs.write_gdino_vocab(
            os.path.join(work, "vocab.txt")))
        res["gdino"] = {}
        for route in ROUTES:
            rows, best = top_queries(net, tok, runs[route]["frame"])
            h, w = runs[route]["frame"].shape[:2]
            inside = (0 <= best[0] < best[2] <= w
                      and 0 <= best[1] < best[3] <= h)
            res["gdino"][route] = dict(top=rows, best_box=best,
                                       inside=inside)
            print(f"{route}: view-0 best box {np.round(best, 2).tolist()} "
                  f"(inside the {w}x{h} image: {inside}); top queries "
                  f"{[(r['query'], r['score'], r['logit']) for r in rows]}",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "gdino"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
