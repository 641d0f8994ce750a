"""DLNR stereo evaluation (EPE / D1 over folders of pairs).

Port of gs2mesh_tpu cli/dlnr_eval.py (the reference's validation harness,
third_party/DLNR/evaluate_stereo.py:22-119: per-pair end-point error and the
D1 fraction of pixels whose error exceeds a threshold, averaged over the
set). Each pair directory holds ``im0``/``im1`` (or ``left``/``right``)
PNGs and a ground-truth disparity (``disp0GT.pfm`` Middlebury-style, or
``disp_gt.npy``); invalid pixels are inf or 0 as in Middlebury.

Usage:
  python -m gs2mesh_torch.cli.dlnr_eval --ckpt DLNR_Middlebury.pth \
      --root <dir-with-pair-subdirs> [--iters 32] [--bad 2.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.png import read_png


def read_pfm(path: str) -> np.ndarray:
    """Middlebury PFM reader (grayscale or RGB; returns (H, W[, 3]) f32)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        w, h = map(int, re.findall(r"\d+", dims))
        scale = float(f.readline().decode("latin-1").strip())
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4",
                           count=w * h * (3 if header == "PF" else 1))
    data = data.reshape(h, w, 3) if header == "PF" else data.reshape(h, w)
    return np.flipud(data).astype(np.float32).copy()  # PFM is bottom-up


def epe_d1(pred: np.ndarray, gt: np.ndarray, valid: np.ndarray,
           bad_px: float) -> dict:
    """Per-pair metrics over valid pixels (evaluate_stereo.py:41-47: EPE =
    mean |pred - gt|; D1 = the fraction with error > bad_px)."""
    err = np.abs(pred - gt)[valid]
    if err.size == 0:
        return {"epe": float("nan"), "d1": float("nan"), "valid_px": 0}
    return {"epe": float(err.mean()),
            "d1": float((err > bad_px).mean()),
            "valid_px": int(err.size)}


def _load_image(path: str) -> np.ndarray:
    """(1, 3, H, W) float32 in [0, 255]; grayscale repeated to RGB, alpha
    dropped."""
    img = read_png(path).astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img[..., :3].transpose(2, 0, 1)[None]


def _find(pair_dir: str, stems, exts):
    for s in stems:
        for e in exts:
            p = os.path.join(pair_dir, s + e)
            if os.path.exists(p):
                return p
    return None


@torch.inference_mode()
def evaluate_folder(model, root: str, iters: int = 32, bad_px: float = 2.0,
                    max_pairs: int | None = None, verbose: bool = True,
                    device="cuda") -> dict:
    """Run DLNR (``model``, a stereo.DLNR) over every pair subdirectory of
    ``root`` and aggregate EPE / D1 (the validate_* loop,
    evaluate_stereo.py:22-60)."""
    from gs2mesh_torch.stereo import DLNRConfig, InputPadder, dlnr_forward

    device = resolve_device(device)
    model = model.to(device).eval()
    cfg = DLNRConfig(iters=iters)
    pair_dirs = sorted(
        d for d in (os.path.join(root, x) for x in os.listdir(root))
        if os.path.isdir(d))
    if max_pairs:
        pair_dirs = pair_dirs[:max_pairs]
    per_pair, epes, d1s = [], [], []
    for pd in pair_dirs:
        left = _find(pd, ("im0", "left"), (".png",))
        right = _find(pd, ("im1", "right"), (".png",))
        gt_pfm = _find(pd, ("disp0GT", "disp0"), (".pfm",))
        gt_npy = _find(pd, ("disp_gt", "disparity_gt"), (".npy",))
        if not (left and right and (gt_pfm or gt_npy)):
            continue
        gt = read_pfm(gt_pfm) if gt_pfm else np.load(gt_npy)
        gt = np.abs(np.asarray(gt, np.float32))
        valid = np.isfinite(gt) & (gt > 0)

        im1, im2 = (torch.from_numpy(_load_image(p)).to(device)
                    for p in (left, right))
        padder = InputPadder(im1.shape, divis_by=32)
        p1, p2 = padder.pad(im1, im2)
        _, flow_up = dlnr_forward(model, p1, p2, cfg)
        disp = -padder.unpad(flow_up).squeeze().cpu().numpy()

        m = epe_d1(disp, gt, valid, bad_px)
        m["pair"] = os.path.basename(pd)
        per_pair.append(m)
        if np.isfinite(m["epe"]):
            epes.append(m["epe"])
            d1s.append(m["d1"])
        if verbose:
            print(f"{m['pair']}: EPE {m['epe']:.4f} "
                  f"D1({bad_px}px) {100 * m['d1']:.2f}%", flush=True)

    summary = {
        "pairs": len(per_pair),
        "epe": float(np.mean(epes)) if epes else float("nan"),
        "d1_pct": float(100 * np.mean(d1s)) if d1s else float("nan"),
        "bad_px": bad_px,
        "iters": iters,
        "per_pair": per_pair,
    }
    if verbose:
        print(f"Validation: EPE {summary['epe']:.4f} "
              f"D1 {summary['d1_pct']:.2f}% over {summary['pairs']} pairs")
    return summary


def main():
    from gs2mesh_torch.pipeline.stereo_stage import load_torch_checkpoint

    ap = argparse.ArgumentParser(description="DLNR stereo evaluation")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--bad", type=float, default=2.0)
    ap.add_argument("--max_pairs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    summary = evaluate_folder(load_torch_checkpoint(args.ckpt), args.root,
                              iters=args.iters, bad_px=args.bad,
                              max_pairs=args.max_pairs, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
