"""Tanks & Temples evaluation protocol (official toolbox semantics).

Port of evaluation/TNT/eval_code/python_toolbox/evaluation/{run.py:55-148,
evaluation.py:60-205, registration.py:44-185, trajectory_io.py, config.py,
plot.py} without Open3D: SfM .log trajectory alignment (known-correspondence
similarity fit where the reference runs zero-jitter RANSAC), 3-stage ICP
refinement (voxel x2 then uniform downsampling), selection-polygon crop
volume, bidirectional point distances -> precision/recall/F1 at the
per-scene tau, cumulative-histogram artifacts + plot.

The port's copy of gs2mesh_tpu evals/tnt.py (host numpy/scipy code, as
there); plot_graph imports matplotlib when it runs.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple

import numpy as np

from gs2mesh_torch.evals.geometry import (icp_point_to_point, nn_distances,
                                          umeyama, voxel_downsample)

MAX_POINT_NUMBER = 4e6

scenes_tau_dict = {
    "Barn": 0.01,
    "Caterpillar": 0.005,
    "Church": 0.025,
    "Courthouse": 0.025,
    "Ignatius": 0.003,
    "Meetingroom": 0.01,
    "Truck": 0.005,
}


class CameraPose(NamedTuple):
    metadata: list
    pose: np.ndarray


def read_trajectory(filename: str) -> List[CameraPose]:
    traj = []
    with open(filename) as f:
        metastr = f.readline()
        while metastr:
            metadata = list(map(int, metastr.split()))
            mat = np.zeros((4, 4))
            for i in range(4):
                mat[i] = np.fromstring(f.readline(), dtype=float, sep=" \t")
            traj.append(CameraPose(metadata, mat))
            metastr = f.readline()
    return traj


def write_trajectory(traj: List[CameraPose], filename: str) -> None:
    with open(filename, "w") as f:
        for x in traj:
            p = x.pose.tolist()
            f.write(" ".join(map(str, x.metadata)) + "\n")
            f.write("\n".join(" ".join("{0:.12f}".format(v) for v in p[i])
                              for i in range(4)))
            f.write("\n")


def trajectory_positions(traj: List[CameraPose]) -> np.ndarray:
    return np.stack([t.pose[:3, 3] for t in traj], axis=0)


def read_mapping(filename: str):
    with open(filename) as f:
        n_sampled = int(f.readline())
        n_total = int(f.readline())
        mapping = np.zeros((n_sampled, 2))
        for i in range(n_sampled):
            mapping[i] = list(map(int, f.readline().split()))
    return n_sampled, n_total, mapping


class CropVolume:
    """Open3D SelectionPolygonVolume equivalent: a polygon in the plane
    orthogonal to `orthogonal_axis`, with [axis_min, axis_max] bounds."""

    def __init__(self, bounding_polygon, orthogonal_axis, axis_min, axis_max):
        self.polygon = np.asarray(bounding_polygon, np.float64)
        self.axis = {"X": 0, "Y": 1, "Z": 2}[orthogonal_axis.upper()]
        self.axis_min = float(axis_min)
        self.axis_max = float(axis_max)

    @staticmethod
    def from_json(path: str) -> "CropVolume":
        with open(path) as f:
            d = json.load(f)
        return CropVolume(d["bounding_polygon"], d["orthogonal_axis"],
                          d["axis_min"], d["axis_max"])

    def contains(self, points: np.ndarray) -> np.ndarray:
        in_axis = ((points[:, self.axis] >= self.axis_min)
                   & (points[:, self.axis] <= self.axis_max))
        dims = [i for i in range(3) if i != self.axis]
        px, py = points[:, dims[0]], points[:, dims[1]]
        vx, vy = self.polygon[:, dims[0]], self.polygon[:, dims[1]]
        n = len(vx)
        inside = np.zeros(len(points), dtype=bool)
        j = n - 1
        for i in range(n):                 # ray casting over polygon edges
            cond = ((vy[i] > py) != (vy[j] > py))
            denom = vy[j] - vy[i]
            denom = np.where(denom == 0, 1e-30, denom)
            xint = (vx[j] - vx[i]) * (py - vy[i]) / denom + vx[i]
            inside ^= cond & (px < xint)
            j = i
        return inside & in_axis

    def crop(self, points: np.ndarray) -> np.ndarray:
        return points[self.contains(points)]


def trajectory_alignment(map_file, traj_to_register, gt_traj_col, gt_trans):
    """Similarity transform mapping the estimated trajectory onto the
    GT-aligned COLMAP trajectory (registration.py:65-104)."""
    gt_pos = trajectory_positions(gt_traj_col)
    gt_pos = gt_pos @ gt_trans[:3, :3].T + gt_trans[:3, 3]
    if len(traj_to_register) > 1600:
        _, _, mapping = read_mapping(map_file)
        est = [traj_to_register[int(m[1] - 1)] for m in mapping]
    else:
        est = traj_to_register
    est_pos = trajectory_positions(est)
    n = min(len(est_pos), len(gt_pos))
    return umeyama(est_pos[:n], gt_pos[:n], with_scaling=True)


def _crop_and_downsample(points, crop_volume, method, voxel_size=0.01,
                         trans=np.eye(4)):
    p = points @ trans[:3, :3].T + trans[:3, 3]
    p = crop_volume.crop(p)
    if method == "voxel":
        return voxel_downsample(p, voxel_size)
    if method == "uniform" and len(p) > MAX_POINT_NUMBER:
        rate = int(round(len(p) / float(MAX_POINT_NUMBER)))
        return p[::rate]
    return p


def registration_vol_ds(source, gt_target, init_trans, crop_volume,
                        voxel_size, threshold, max_itr):
    s = _crop_and_downsample(source, crop_volume, "voxel", voxel_size,
                             init_trans)
    t = _crop_and_downsample(gt_target, crop_volume, "voxel", voxel_size)
    T, _, _ = icp_point_to_point(s, t, threshold, max_iteration=max_itr)
    return T @ init_trans


def registration_unif(source, gt_target, init_trans, crop_volume, threshold,
                      max_itr):
    s = _crop_and_downsample(source, crop_volume, "uniform",
                             trans=init_trans)
    t = _crop_and_downsample(gt_target, crop_volume, "uniform")
    T, _, _ = icp_point_to_point(s, t, threshold, max_iteration=max_itr)
    return T @ init_trans


def evaluate_histo(source, target, trans, crop_volume, voxel_size, threshold,
                   out_dir, plot_stretch, scene_name):
    """Crop + voxel downsample + bidirectional distances -> P/R/F1 and
    cumulative histograms (evaluation.py:60-205)."""
    s = source @ trans[:3, :3].T + trans[:3, 3]
    s = voxel_downsample(crop_volume.crop(s), voxel_size)
    t = voxel_downsample(crop_volume.crop(target), voxel_size)
    distance1 = nn_distances(s, t)                      # precision
    distance2 = nn_distances(t, s)                      # recall

    if len(distance1) and len(distance2):
        precision = float((distance1 < threshold).sum()) / len(distance1)
        recall = float((distance2 < threshold).sum()) / len(distance2)
        fscore = 2 * recall * precision / max(recall + precision, 1e-12)
        bins = np.arange(0, threshold * plot_stretch, threshold / 100)
        h1, edges_source = np.histogram(distance1, bins)
        cum_source = np.cumsum(h1).astype(float) / len(distance1)
        h2, edges_target = np.histogram(distance2, bins)
        cum_target = np.cumsum(h2).astype(float) / len(distance2)
    else:
        precision = recall = fscore = 0
        edges_source = cum_source = edges_target = cum_target = np.array([0])

    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, f"{scene_name}.recall.txt"), cum_target)
    np.savetxt(os.path.join(out_dir, f"{scene_name}.precision.txt"),
               cum_source)
    np.savetxt(os.path.join(out_dir, f"{scene_name}.prf_tau_plotstr.txt"),
               np.array([precision, recall, fscore, threshold,
                         plot_stretch]))
    return (precision, recall, fscore, edges_source, cum_source,
            edges_target, cum_target)


def plot_graph(scene, fscore, dist_threshold, edges_source, cum_source,
               edges_target, cum_target, plot_stretch, out_dir):
    """Precision/recall cumulative plot (plot.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = plt.figure()
    plt_size = [1, 1]
    pfontsize = "medium"
    ax = plt.subplot(111)
    label_str = "precision"
    ax.plot(edges_source[1::], cum_source * 100, c="red", label=label_str,
            linewidth=2.0)
    label_str = "recall"
    ax.plot(edges_target[1::], cum_target * 100, c="blue", label=label_str,
            linewidth=2.0)
    ax.grid(True)
    plt.rcParams["figure.figsize"] = plt_size
    plt.rc("axes", prop_cycle=matplotlib.cycler(color=["r", "g", "b", "y"]))
    plt.title(f"{scene} (F1 = {fscore * 100:.2f}% @ d = {dist_threshold})")
    plt.axvline(x=dist_threshold, c="black", ls="dashed", linewidth=2.0)
    plt.ylabel("# of points (%)", fontsize=15)
    plt.xlabel("Meters", fontsize=15)
    plt.axis([0, dist_threshold * plot_stretch, 0, 100])
    ax.legend(shadow=True, fancybox=True, fontsize=pfontsize)
    png_name = os.path.join(out_dir, f"PR_{scene}_@d_th_0_{int(dist_threshold * 10000)}.png")
    f.savefig(png_name, format="png", bbox_inches="tight")
    plt.close(f)


def run_evaluation(dataset_dir: str, traj_path: str, ply_path: str,
                   out_dir: str):
    """Official protocol driver (run.py:55-148). Returns [P, R, F1]."""
    from gs2mesh_torch.core.ply import read_points_colors

    scene = os.path.basename(os.path.normpath(dataset_dir))
    if scene not in scenes_tau_dict:
        raise Exception("invalid dataset-dir, not in scenes_tau_dict")
    print(f"\n===========================\nEvaluating {scene}\n"
          "===========================")
    dTau = scenes_tau_dict[scene]

    colmap_ref_logfile = os.path.join(dataset_dir, scene + "_COLMAP_SfM.log")
    alignment = os.path.join(dataset_dir, scene + "_trans.txt")
    gt_filen = os.path.join(dataset_dir, scene + ".ply")
    cropfile = os.path.join(dataset_dir, scene + ".json")
    map_file = os.path.join(dataset_dir, scene + "_mapping_reference.txt")

    os.makedirs(out_dir, exist_ok=True)
    pcd, _ = read_points_colors(ply_path)
    gt_pcd, _ = read_points_colors(gt_filen)

    gt_trans = np.loadtxt(alignment)
    traj_to_register = read_trajectory(traj_path)
    gt_traj_col = read_trajectory(colmap_ref_logfile)
    trajectory_transform = trajectory_alignment(
        map_file, traj_to_register, gt_traj_col, gt_trans)

    vol = CropVolume.from_json(cropfile)
    r2 = registration_vol_ds(pcd, gt_pcd, trajectory_transform, vol, dTau,
                             dTau * 80, 20)
    r3 = registration_vol_ds(pcd, gt_pcd, r2, vol, dTau / 2.0, dTau * 20, 20)
    r = registration_unif(pcd, gt_pcd, r3, vol, 2 * dTau, 20)

    plot_stretch = 5
    (precision, recall, fscore, edges_source, cum_source, edges_target,
     cum_target) = evaluate_histo(pcd, gt_pcd, r, vol, dTau / 2.0, dTau,
                                  out_dir, plot_stretch, scene)
    print("==============================")
    print(f"evaluation result : {scene}")
    print("==============================")
    print(f"distance tau : {dTau:.3f}")
    print(f"precision : {precision:.4f}")
    print(f"recall : {recall:.4f}")
    print(f"f-score : {fscore:.4f}")
    print("==============================")
    plot_graph(scene, fscore, dTau, edges_source, cum_source, edges_target,
               cum_target, plot_stretch, out_dir)
    return [precision, recall, fscore]
