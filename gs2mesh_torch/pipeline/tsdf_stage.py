"""TSDF fusion stage: the rendered views' depth maps -> mesh PLYs.

Port of gs2mesh_tpu pipeline/tsdf_stage.py (the reference's
gs2mesh_utils/tsdf_utils.py:23-182). Per view it reads left.png (with the
port's PNG reader) and depth.npy, applies the object mask (optional invert
and close + erode, :68-78) and the occlusion mask (:79-81), zeroes depth
below min_baselines * baseline (:83), divides depth and the camera-to-world
translation by TSDF_scale (:85-86), truncates depth at
baseline * max_baselines / scale, and fuses the view into the block-sparse
volume on the stage's device (``fusion.allocate`` + ``fusion.integrate``).
Then it extracts the mesh on the device, rescales it, and cleans small
triangle clusters on the host. Like the JAX stage, it keeps the normals that
marching computed before the rescale (the JAX stage's normal recompute never
runs: ``gs2mesh_tpu.fusion`` has no ``recompute_normals``).

On a block overflow the view's allocation is redone on a volume of twice the
capacity, before its integration: the voxel data is updated in place, so no
snapshot of the volume is kept. Each part runs in a ``record_function``
range named in STAGE_RANGES (``tsdf.<name>``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from gs2mesh_torch import fusion, resolve_device
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.pipeline.masker_stage import morph_close_erode

STAGE_RANGES = ("read", "mask", "allocate", "integrate", "extract", "clean",
                "write")


class TSDF:
    def __init__(self, renderer, stereo, args, out_name: str, device="cuda"):
        self.device = resolve_device(device)
        self.model_name = stereo.model_name
        self.renderer = renderer
        self.args = args
        self.out_name = out_name
        self.mesh: Optional[fusion.Mesh] = None
        self.cleaned: Optional[fusion.Mesh] = None
        self.cfg: Optional[fusion.TSDFConfig] = None
        self.volume: Optional[fusion.TSDFVolume] = None

    def views(self):
        """(camera_number, left_camera) of the views the stage fuses: every
        TSDF_dilate-th, within TSDF_valid, not in TSDF_skip."""
        args = self.args
        valid = args.TSDF_valid if args.TSDF_valid is not None \
            else list(range(len(self.renderer)))
        skip = args.TSDF_skip if args.TSDF_skip is not None else []
        for camera_number, left_camera in enumerate(
                self.renderer.left_cameras):
            if camera_number % args.TSDF_dilate != 0:
                continue
            if camera_number not in valid or camera_number in skip:
                continue
            yield camera_number, left_camera

    def run(self, block_capacity: int = 1 << 14) -> None:
        args = self.args
        voxel_length = args.TSDF_voxel / 512.0
        cfg = fusion.TSDFConfig(voxel_size=float(voxel_length),
                                sdf_trunc=float(args.TSDF_sdf_trunc),
                                block_capacity=block_capacity)
        vol = fusion.create_volume(cfg, self.device)

        baseline = self.renderer.baseline
        depth_trunc = baseline * args.TSDF_max_depth_baselines / \
            args.TSDF_scale

        for camera_number, left_camera in self.views():
            out_dir = self.renderer.render_folder_name(camera_number)
            with record_function("tsdf.read"):
                image = read_png(os.path.join(out_dir, "left.png"))
                depth = np.load(os.path.join(
                    out_dir, f"out_{self.model_name}", "depth.npy"))

            with record_function("tsdf.mask"):
                if args.TSDF_use_mask:
                    object_mask = np.load(os.path.join(
                        out_dir, "left_mask.npy")).astype(bool)
                    if args.TSDF_invert_mask:
                        object_mask = ~object_mask
                    if args.TSDF_erode_mask:
                        object_mask = morph_close_erode(
                            object_mask, args.TSDF_closing_kernel_size,
                            args.TSDF_erosion_kernel_size)
                    depth = depth * object_mask
                if args.TSDF_use_occlusion_mask:
                    occ = np.load(os.path.join(
                        out_dir, f"out_{self.model_name}",
                        "occlusion_mask.npy")).astype(bool)
                    depth = depth * occ

                depth = np.where(
                    depth < args.TSDF_min_depth_baselines * baseline, 0.0,
                    depth)
                # o3d depth_scale: metric depth = stored / TSDF_scale.
                depth = depth.astype(np.float32) / args.TSDF_scale

                # camera-to-world from RT_from_rot_pos; Open3D integrates
                # with its inverse (tsdf_utils.py:106).
                extrinsic = np.asarray(left_camera["extrinsic"],
                                       np.float64).copy()
                if extrinsic.shape[0] == 3:
                    extrinsic = np.vstack([extrinsic, [0, 0, 0, 1]])
                extrinsic[:3, 3] /= args.TSDF_scale
                K = np.array([[left_camera["fx"], 0, left_camera["cx"]],
                              [0, left_camera["fy"], left_camera["cy"]],
                              [0, 0, 1.0]], np.float32)
                world_to_cam = np.linalg.inv(extrinsic).astype(np.float32)
                color = image[..., :3].astype(np.float32) / np.float32(255.0)
                color, depth, K, world_to_cam = (
                    torch.from_numpy(a).to(self.device)
                    for a in (color, depth, K, world_to_cam))

            with record_function("tsdf.allocate"):
                # Unbounded allocation (ScalableTSDFVolume): on block
                # overflow, double the capacity and redo the allocation;
                # nothing of this view has been integrated yet.
                fresh = fusion.allocate(vol, depth, K, world_to_cam,
                                        depth_trunc, cfg)
                while fresh.overflow:
                    vol, cfg = fusion.grow_volume(vol, cfg)
                    print(f"[tsdf] block capacity -> {cfg.block_capacity} "
                          f"(view {camera_number} overflowed)")
                    fresh = fusion.allocate(vol, depth, K, world_to_cam,
                                            depth_trunc, cfg)
                vol = fresh
            with record_function("tsdf.integrate"):
                vol = fusion.integrate(vol, color, depth, K, world_to_cam,
                                       depth_trunc, cfg)

        with record_function("tsdf.extract"):
            mesh = fusion.extract_triangle_mesh(vol, cfg)
            self.mesh = fusion.scale_mesh(mesh, float(self.args.TSDF_scale))
        self.cfg, self.volume = cfg, vol

    def save_mesh(self) -> str:
        path = os.path.join(self.renderer.output_dir_root,
                            f"{self.out_name}_mesh.ply")
        with record_function("tsdf.write"):
            fusion.write_mesh(path, self.mesh)
        print("SAVED MESH")
        return path

    def clean_mesh(self) -> str:
        thres = self.args.TSDF_cleaning_threshold / self.args.TSDF_scale
        with record_function("tsdf.clean"):
            self.cleaned = fusion.clean_mesh(self.mesh,
                                             min_triangles=int(thres))
        path = os.path.join(self.renderer.output_dir_root,
                            f"{self.out_name}_cleaned_mesh.ply")
        with record_function("tsdf.write"):
            fusion.write_mesh(path, self.cleaned)
        print("SAVED CLEANED MESH")
        return path
