"""DTU evaluation: observation-mask culling + bidirectional chamfer.

Port of evaluation/DTU/eval_code/{evaluate_single_scene.py:21-116, eval.py:
27-166} (DTUeval-python protocol): cull mesh vertices to those inside every
view's disk(24)-dilated observation mask, rescale by scale_mat, then sample
the surface at 0.2mm density, radius-downsample, bound by ObsMask + ground
plane, and compute d2s (accuracy) / s2d (completeness) / overall chamfer
with max_dist 20, writing colored error PLYs + results.json.

The port's copy of gs2mesh_tpu evals/dtu.py, host numpy/scipy code as
there, without OpenCV or PIL: the camera matrix is decomposed by scipy's RQ
(load_K_Rt_from_P) and the masks are read with the port's PNG reader.
dtu_eval's parts run in record_function ranges named in EVAL_RANGES
("dtu_eval.<name>"), so a profile splits its host time.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from torch.profiler import record_function

from gs2mesh_torch.core.ply import read_points_colors, write_ply
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.evals.geometry import (nn_distances, radius_downsample,
                                          sample_mesh_surface)

EVAL_RANGES = ("sample", "downsample", "d2s", "s2d")


def decompose_projection_matrix(P: np.ndarray):
    """3x4 camera matrix -> (K, R, C): K upper triangular with a positive
    diagonal and R a rotation with P ~ K [R | -R C], as
    cv2.decomposeProjectionMatrix gives them (its K unnormalised, its
    homogeneous centre here as the 3-vector C), in float64."""
    import scipy.linalg

    P = np.asarray(P, np.float64)
    K, R = scipy.linalg.rq(P[:, :3])
    signs = np.diag(np.sign(np.diag(K)))
    K, R = K @ signs, signs @ R
    centre = np.linalg.svd(P)[2][-1]          # P's null space
    return K, R, centre[:3] / centre[3]


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 camera matrix into K and cam-to-world pose
    (IDR rend_util convention used by evaluate_single_scene.py:35-38)."""
    K, R, centre = decompose_projection_matrix(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = centre
    return intrinsics, pose


def _disk_footprint(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y) <= radius * radius


def cull_scan(scan: int, mesh_vertices: np.ndarray, mesh_faces: np.ndarray,
              dtu_dataset_dir: str,
              dilation_radius: int = 24,
              image_wh: Tuple[int, int] = (1600, 1200)):
    """Cull mesh to multi-view observation masks
    (evaluate_single_scene.py:21-116). Returns (vertices, faces) in
    world (mm) scale."""
    import glob

    from scipy.ndimage import binary_dilation

    instance_dir = os.path.join(dtu_dataset_dir, f"scan{scan}")
    image_paths = sorted(glob.glob(os.path.join(instance_dir, "images",
                                                "*.png")))
    n_images = len(image_paths)
    cams = np.load(os.path.join(instance_dir, "cameras.npz"))
    scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                  for i in range(n_images)]
    world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                  for i in range(n_images)]

    W, H = image_wh
    verts_h = np.concatenate([mesh_vertices,
                              np.ones_like(mesh_vertices[:, :1])], axis=-1)
    keep = np.ones(len(mesh_vertices), dtype=bool)
    footprint = _disk_footprint(dilation_radius)

    mask_paths = sorted(glob.glob(os.path.join(instance_dir, "mask",
                                               "*.png")))
    for i in range(n_images):
        P = (world_mats[i] @ scale_mats[i])[:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        w2c = np.linalg.inv(pose)
        cam_pts = (intr @ w2c @ verts_h.T)[:3]
        pix = cam_pts[:2] / (cam_pts[2:3] + 1e-6)           # (2, V)
        u, v = pix[0], pix[1]
        valid = (u / (W - 1) > 0.0) & (u / (W - 1) < 1.0) \
            & (v / (H - 1) > 0.0) & (v / (H - 1) < 1.0)

        mask = read_png(mask_paths[i])
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        mask = binary_dilation(mask.astype(np.float32) / 256.0 > 0,
                               structure=footprint)
        ui = np.clip(np.round(u).astype(np.int64), 0, W - 1)
        vi = np.clip(np.round(v).astype(np.int64), 0, H - 1)
        sampled = np.where(valid, mask[vi, ui], 0.0)
        keep &= (sampled + (1.0 - valid)) > 0.0

    face_keep = keep[mesh_faces].all(axis=1)
    remap = np.cumsum(keep) - 1
    new_faces = remap[mesh_faces[face_keep]]
    new_verts = mesh_vertices[keep]
    scale_mat = scale_mats[0]
    new_verts = new_verts * scale_mat[0, 0] + scale_mat[:3, 3][None]
    return new_verts, new_faces


def dtu_eval(vertices: np.ndarray, faces: np.ndarray, scan: int,
             dataset_dir: str, vis_out_dir: str,
             downsample_density: float = 0.2, patch_size: float = 60,
             max_dist: float = 20, visualize_threshold: float = 10,
             seed: int = 0) -> dict:
    """DTUeval-python metric (eval.py:27-166)."""
    from scipy.io import loadmat

    thresh = downsample_density
    with record_function("dtu_eval.sample"):
        new_pts = sample_mesh_surface(vertices, faces, thresh)
        data_pcd = np.concatenate([vertices, new_pts], axis=0)
    with record_function("dtu_eval.downsample"):
        data_down = radius_downsample(data_pcd, thresh, seed=seed)

    obs = loadmat(os.path.join(dataset_dir, "ObsMask",
                               f"ObsMask{scan}_10.mat"))
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), \
        obs["Res"]

    inbound = ((data_down >= BB[:1] - patch_size)
               & (data_down < BB[1:] + patch_size * 2)).sum(axis=-1) == 3
    data_in = data_down[inbound]

    data_grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_inbound = ((data_grid >= 0)
                    & (data_grid < np.expand_dims(ObsMask.shape, 0))
                    ).sum(axis=-1) == 3
    data_grid_in = data_grid[grid_inbound]
    in_obs = ObsMask[data_grid_in[:, 0], data_grid_in[:, 1],
                     data_grid_in[:, 2]].astype(bool)
    data_in_obs = data_in[grid_inbound][in_obs]

    stl, _ = read_points_colors(os.path.join(
        dataset_dir, "Points", "stl", f"stl{scan:03}_total.ply"))

    with record_function("dtu_eval.d2s"):
        dist_d2s = nn_distances(data_in_obs, stl)
    mean_d2s = dist_d2s[dist_d2s < max_dist].mean()

    ground_plane = loadmat(os.path.join(dataset_dir, "ObsMask",
                                        f"Plane{scan}.mat"))["P"]
    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (ground_plane.reshape((1, 4)) * stl_hom).sum(-1) > 0
    stl_above = stl[above]

    with record_function("dtu_eval.s2d"):
        dist_s2d = nn_distances(stl_above, data_in)
    mean_s2d = dist_s2d[dist_s2d < max_dist].mean()

    # colored error clouds (eval.py:137-152)
    os.makedirs(vis_out_dir, exist_ok=True)
    R = np.array([[1, 0, 0]], np.float64)
    G = np.array([[0, 1, 0]], np.float64)
    B = np.array([[0, 0, 1]], np.float64)
    Wc = np.array([[1, 1, 1]], np.float64)
    data_color = np.tile(B, (data_down.shape[0], 1))
    alpha = np.clip(dist_d2s, None, visualize_threshold)[:, None] \
        / visualize_threshold
    sel = np.where(inbound)[0][grid_inbound][in_obs]
    data_color[sel] = R * alpha + Wc * (1 - alpha)
    data_color[sel[dist_d2s >= max_dist]] = G
    _write_colored(os.path.join(vis_out_dir, f"vis_{scan:03}_d2s.ply"),
                   data_down, data_color)
    stl_color = np.tile(B, (stl.shape[0], 1))
    alpha = np.clip(dist_s2d, None, visualize_threshold)[:, None] \
        / visualize_threshold
    sel = np.where(above)[0]
    stl_color[sel] = R * alpha + Wc * (1 - alpha)
    stl_color[sel[dist_s2d >= max_dist]] = G
    _write_colored(os.path.join(vis_out_dir, f"vis_{scan:03}_s2d.ply"),
                   stl, stl_color)

    overall = (mean_d2s + mean_s2d) / 2
    result = {"mean_d2s": float(mean_d2s), "mean_s2d": float(mean_s2d),
              "overall": float(overall)}
    with open(os.path.join(vis_out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=True)
    print(mean_d2s, mean_s2d, overall)
    return result


def _write_colored(path: str, points: np.ndarray, colors: np.ndarray):
    write_ply(path, {
        "x": points[:, 0].astype(np.float32),
        "y": points[:, 1].astype(np.float32),
        "z": points[:, 2].astype(np.float32),
        "red": (colors[:, 0] * 255).astype(np.uint8),
        "green": (colors[:, 1] * 255).astype(np.uint8),
        "blue": (colors[:, 2] * 255).astype(np.uint8),
    })
