"""Stereo novel-view renderer stage.

Port of gs2mesh_tpu pipeline/renderer_stage.py (the reference Renderer,
gs2mesh_utils/renderer_utils.py): loads COLMAP poses + the trained GS
point_cloud.ply, computes the stereo baseline (median radius for 360 scenes,
x2 for DTU, or a least-squares sphere fit otherwise), optionally greedily
orders the cameras, builds the left/right camera dicts, saves
camera_data.json, and renders each pair to NNN/left.png + right.png (by
``core/png.py::write_png``) on the model's device (CUDA kernels by
default).
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core import transforms as tf
from gs2mesh_torch.core.camera import camera_from_euler
from gs2mesh_torch.core.png import write_png
from gs2mesh_torch.core.ply import read_points_colors


def find_nearest_neighbors(current_index, coordinates, visited):
    """The two nearest unvisited cameras (renderer_utils.py:33-48), or the
    one left. The JAX package also returns a visited camera at distance inf
    when one is left, which choose_by_close_z can pick, and its sort then
    never ends; where it ends, it never picked a visited camera, so the two
    orders agree."""
    distances = np.linalg.norm(coordinates - coordinates[current_index],
                               axis=1)
    distances[visited] = np.inf
    distances[current_index] = np.inf
    nearest = np.argsort(distances)[:2]
    return nearest[np.isfinite(distances[nearest])]


def choose_by_close_z(current_index, candidates, coordinates):
    z_diff = np.abs(coordinates[candidates][:, 2]
                    - coordinates[current_index][2])
    return candidates[np.argmin(z_diff)]


def sort_camera_coordinates(coordinates):
    """Greedy neighbor ordering starting at min-z (renderer_utils.py:69-99)."""
    visited = np.zeros(len(coordinates), dtype=bool)
    order = []
    current = int(np.argmin(coordinates[:, 2]))
    while not np.all(visited):
        visited[current] = True
        order.append(current)
        if np.all(visited):
            break
        nn = find_nearest_neighbors(current, coordinates, visited)
        if len(nn) == 0:
            break
        current = int(choose_by_close_z(current, nn, coordinates))
    return order


def compute_baseline(camera_locations: np.ndarray, args) -> float:
    """Stereo baseline from scene scale (renderer_utils.py:154-170)."""
    if args.renderer_baseline_absolute is not None:
        return float(args.renderer_baseline_absolute)
    ts = np.asarray(camera_locations, dtype=np.float64)
    if args.renderer_scene_360:
        radius = float(np.median(np.linalg.norm(ts - ts.mean(axis=0),
                                                axis=1)))
        if args.dataset_name == "DTU":
            radius *= 2
    else:
        radius = tf.sphere_fit_radius(ts)
    return radius * (args.renderer_baseline_percentage / 100.0)


class Renderer:
    def __init__(self, base_dir: str, colmap_dir: str, output_dir_root: str,
                 args, dataset: str = "custom", splatting: str = "custom",
                 experiment_name: Optional[str] = None,
                 ply_path: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.args = args
        self.render_name = args.colmap_name
        self.white_background = args.GS_white_background
        self.base_dir = base_dir
        self.colmap_dir = colmap_dir
        self.output_dir_root = output_dir_root
        self.splatting_iteration = args.GS_iterations
        self.splatting_dir = os.path.join(base_dir, "splatting_output",
                                          splatting, self.render_name)
        self.ply_path = ply_path or os.path.join(
            self.splatting_dir, "point_cloud",
            f"iteration_{self.splatting_iteration}", "point_cloud.ply")

        sparse = os.path.join(colmap_dir, "sparse", "0")
        images = colmap_io.read_images_text(os.path.join(sparse,
                                                         "images.txt"))
        self.poses = colmap_io.poses_from_model(images)      # (N, 3, 4) w2c

        # Camera-to-world rotations/locations with the GS-convention flip
        # (renderer_utils.py:134-140) before taking the Euler description.
        cam_rotations: List[np.ndarray] = []
        cam_locations: List[list] = []
        for pose in self.poses:
            pose4 = np.vstack([pose, np.array([0.0, 0.0, 0.0, 1.0])])
            inv = np.linalg.inv(pose4)
            rot = inv[:3, :3].copy()
            rot[:, 1:] *= -1
            cam_rotations.append(tf.rotm2eul(rot))
            cam_locations.append(inv[:3, 3].tolist())

        cams = colmap_io.read_cameras_text(os.path.join(sparse,
                                                        "cameras.txt"))
        cam_params = []
        for i in sorted(cams.keys()):
            c = cams[i]
            simple = c.model == "SIMPLE_RADIAL" or c.model == "SIMPLE_PINHOLE"
            cam_params.append({
                "width": int(c.width), "height": int(c.height),
                "fx": float(c.params[0]),
                "fy": float(c.params[0 if simple else 1]),
                "cx": float(c.params[1 if simple else 2]),
                "cy": float(c.params[2 if simple else 3]),
            })
        if len(cam_params) != len(cam_locations):
            cam_params = [cam_params[0]] * len(cam_locations)

        self.baseline = compute_baseline(np.array(cam_locations), args)

        if args.renderer_sort_cameras:
            self.sorted_camera_indices = sort_camera_coordinates(
                np.array(cam_locations))
            self.poses = self.poses[np.array(self.sorted_camera_indices)]
        else:
            self.sorted_camera_indices = list(range(len(cam_locations)))

        self.cameras = []
        for i in range(len(cam_locations)):
            ci = self.sorted_camera_indices[i]
            rot = tuple(cam_rotations[ci].tolist())
            pos = tuple(cam_locations[ci])
            R_right, T_right = tf.calculate_right_camera_pose(
                cam_rotations[ci], cam_locations[ci], self.baseline)
            common = {k: cam_params[ci][k] for k in
                      ("width", "height", "fx", "fy", "cx", "cy")}
            intr = tf.intrinsic_from_camera_params(cam_params[ci])
            extr = tf.RT_from_rot_pos(rot, pos)
            self.cameras.append({
                "left": dict(rot=rot, pos=pos, **common, intrinsic=intr,
                             extrinsic=extr, baseline=self.baseline),
                "right": dict(rot=R_right, pos=T_right, **common,
                              intrinsic=intr, extrinsic=extr),
            })

        print(f"num views: {len(self.cameras)}")
        print(f"baseline: {self.baseline}")
        self.left_cameras = [c["left"] for c in self.cameras]

        if args.renderer_save_json:
            self.save_camera_data()

        self.GS_ply_points, _ = read_points_colors(self.ply_path) \
            if os.path.exists(self.ply_path) else (np.zeros((0, 3)), None)
        self._model = None
        self._inputs = None
        self.last_output = None   # RasterizeOutput of the latest render

    def __len__(self):
        return len(self.cameras)

    def render_folder_name(self, render_number: int) -> str:
        return os.path.join(self.output_dir_root, f"{render_number:03}")

    def save_camera_data(self) -> None:
        """camera_data.json with list-ified matrices (renderer_utils.py:
        298-314), the layout downstream tools consume."""
        os.makedirs(self.output_dir_root, exist_ok=True)
        out = copy.deepcopy(self.cameras)
        for cam in out:
            for side in ("left", "right"):
                cam[side]["intrinsic"] = np.asarray(
                    cam[side]["intrinsic"]).tolist()
                cam[side]["extrinsic"] = np.asarray(
                    cam[side]["extrinsic"]).tolist()
        with open(os.path.join(self.output_dir_root, "camera_data.json"),
                  "w") as f:
            json.dump(out, f, indent=4)

    def prepare_renderer(self, pair_capacity: int = 1 << 22) -> None:
        """Load the trained GS model onto the device (renderer_utils.py:
        316-361)."""
        from gs2mesh_torch.models.gaussians import GaussianModel
        from gs2mesh_torch.ops.rasterizer import RasterizerConfig

        self._model = GaussianModel.load_ply(self.ply_path,
                                             device=self.device)
        self._cfg = RasterizerConfig(pair_capacity=pair_capacity)
        self._bg = torch.full((3,), 1.0 if self.white_background else 0.0,
                              dtype=torch.float32, device=self.device)
        self._inputs = self._model.raster_inputs()

    @torch.no_grad()
    def render_single(self, camera: dict) -> np.ndarray:
        """Render one camera dict -> (H, W, 3) float image in [0, 1]. Raises
        if the frame needs more than pair_capacity pairs."""
        from gs2mesh_torch.ops.rasterizer import rasterize

        if self._inputs is None:
            self.prepare_renderer()
        cam = camera_from_euler(camera["rot"], camera["pos"], camera["fx"],
                                camera["fy"], camera["width"],
                                camera["height"], device=self.device)
        inp = self._inputs
        out = rasterize(inp["means3d"], inp["scales"], inp["rotations"],
                        inp["opacities"], inp["shs"], cam,
                        self._model.max_sh_degree, bg=self._bg,
                        cfg=self._cfg)
        self.last_output = out
        img = torch.clamp(out.image, 0.0, 1.0).permute(1, 2, 0).cpu().numpy()
        if bool(out.overflow) or bool(out.tile_overflow):
            raise RuntimeError(
                f"render needs {int(out.num_pairs)} pairs (pair_capacity "
                f"{self._cfg.pair_capacity}, tile_overflow "
                f"{bool(out.tile_overflow)}): raise the capacity in "
                f"prepare_renderer")
        return img

    def render_image_pair(self, camera_number: int,
                          save: bool = True) -> dict:
        """Render the stereo pair for one view; writes NNN/left.png +
        right.png (renderer_utils.py:363-395). Returns the float images."""
        pair = self.cameras[camera_number]
        out_dir = self.render_folder_name(camera_number)
        images = {}
        for name in ("left", "right"):
            img = self.render_single(pair[name])
            images[name] = img
            if save:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"{name}.png"),
                          np.clip(img * 255.0, 0, 255).astype(np.uint8))
        return images
