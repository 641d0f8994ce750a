"""MobileBrick evaluation protocol.

Port of evaluation/MobileBrick/eval_code/evaluate.py:19-107 without
Open3D/torch/sklearn: ICP-align the prediction to GT (applied only when
fitness > 0.99), crop by the dataset's visibility volume (nearest-neighbor
grid sample), sample 100k surface points from each mesh, and report
accuracy/recall/F1 at 2.5mm and 5mm plus the chamfer distance.

The port's copy of gs2mesh_tpu evals/mobilebrick.py (host numpy/scipy code,
as there).
"""

from __future__ import annotations

import os

import numpy as np

from gs2mesh_torch.core.ply import read_ply, write_mesh_ply
from gs2mesh_torch.evals.geometry import (area_weighted_samples,
                                          icp_point_to_point, nn_distances)


def visibility_test(volume, min_pts, resolution, voxel_size,
                    vertices, faces):
    """Keep mesh vertices whose nearest visibility voxel is occupied
    (evaluate.py:34-44: grid_sample nearest, align_corners=True, zeros)."""
    resolution = np.asarray(resolution).reshape(-1)
    vox = (vertices - np.asarray(min_pts).reshape(1, 3)) / voxel_size
    idx = np.round(vox).astype(np.int64)                   # nearest
    inb = np.all((idx >= 0) & (idx < resolution[None, :3]), axis=1)
    vis = np.zeros(len(vertices), dtype=bool)
    sel = idx[inb]
    vis[inb] = volume[sel[:, 0], sel[:, 1], sel[:, 2]] > 0
    keep = vis
    face_keep = keep[faces].all(axis=1)
    remap = np.cumsum(keep) - 1
    return vertices[keep], remap[faces[face_keep]]


def evaluate(pred_points, gt_points, threshold, verbose=False) -> dict:
    """Bidirectional NN metrics (evaluate.py:46-66)."""
    d_pg = nn_distances(pred_points, gt_points)
    pred_gt_dist = float(np.mean(d_pg))
    precision = float((d_pg < threshold).sum()) / len(d_pg)
    d_gp = nn_distances(gt_points, pred_points)
    gt_pred_dist = float(np.mean(d_gp))
    recall = float((d_gp < threshold).sum()) / len(d_gp)
    F1 = 2 * precision * recall / max(precision + recall, 1e-12)
    chamfer = pred_gt_dist + gt_pred_dist
    if verbose:
        print(f"precision @ {threshold}: {precision:.6f}")
        print(f"recall @ {threshold}: {recall:.6f}")
        print(f"F1: {F1:.6f}")
        print(f"Chamfer: {chamfer:.6f}")
    return {"pred_gt": pred_gt_dist, "accuracy": precision,
            "gt_pred": gt_pred_dist, "recall": recall,
            "chamfer": chamfer, "F1": F1}


def _read_mesh(path):
    d = read_ply(path)
    v = d.vertex
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    faces = d.faces if d.faces is not None else np.zeros((0, 3), np.int64)
    return verts, np.asarray(faces, np.int64)


def evaluate_single(gt_dir: str, pred_path: str, exp_path: str,
                    scan_name: str):
    """Per-scan driver (evaluate.py:72-107). Returns the CSV row
    [chamfer, acc2.5, rec2.5, f1_2.5, acc5, rec5, f1_5]."""
    vis = np.load(os.path.join(gt_dir, "visibility_mask.npy"),
                  allow_pickle=True).item()
    resolution = vis["resolutions"]
    volume = vis["mask"].reshape(resolution)
    voxel_size = vis["voxel_size"]
    min_pts = vis["min_pts"]

    gt_verts, gt_faces = _read_mesh(os.path.join(gt_dir, "mesh",
                                                 "gt_mesh.ply"))
    gt_points = area_weighted_samples(gt_verts, gt_faces, 100000, seed=0)
    pred_verts, pred_faces = _read_mesh(pred_path)

    T, fitness, _ = icp_point_to_point(gt_verts, pred_verts,
                                       max_corr_dist=0.02,
                                       max_iteration=10)
    if fitness > 0.99:
        inv = np.linalg.inv(T)
        pred_verts = pred_verts @ inv[:3, :3].T + inv[:3, 3]

    pred_verts, pred_faces = visibility_test(
        volume, min_pts, resolution, voxel_size, pred_verts, pred_faces)
    if len(pred_faces) > 0:
        pred_points = area_weighted_samples(pred_verts, pred_faces, 100000,
                                            seed=1)
    else:
        pred_points = np.random.default_rng(1).permutation(
            pred_verts)[:100000]

    os.makedirs(exp_path, exist_ok=True)
    write_mesh_ply(os.path.join(exp_path, f"{scan_name}_cropped.ply"),
                   pred_verts.astype(np.float32),
                   pred_faces.astype(np.int32))

    out_25 = evaluate(pred_points, gt_points, threshold=0.0025)
    out_5 = evaluate(pred_points, gt_points, threshold=0.005)
    return [out_25["chamfer"], out_25["accuracy"], out_25["recall"],
            out_25["F1"], out_5["accuracy"], out_5["recall"], out_5["F1"]]
