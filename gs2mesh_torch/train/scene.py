"""COLMAP scene ingestion for GS training.

Port of gs2mesh_tpu train/scene.py (the reference Scene / dataset_readers
path, scene/dataset_readers.py:132-177 and utils/camera_utils.py:19-60):
reads the sparse model (binary or text), loads the images with the port's
PNG reader (``core/png.py``), rescales them by the reference's resolution
rule, computes the NeRF++ normalization (radius = 1.1 x the largest camera
distance from their centre, which becomes spatial_lr_scale) and builds the
cameras on ``device``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.camera import Camera, focal2fov, make_camera
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.core.transforms import qvec2rotmat_wxyz


class SceneData(NamedTuple):
    cameras: List[Camera]
    images: List[np.ndarray]          # (3, H, W) float in [0, 1]
    points: np.ndarray                # (P, 3) SfM points
    colors: np.ndarray                # (P, 3) in [0, 1]
    nerf_norm_radius: float           # spatial_lr_scale
    nerf_norm_translate: np.ndarray
    train_indices: List[int]
    test_indices: List[int]


def get_nerfpp_norm(cam_centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """translate / radius normalization (dataset_readers.py:45-66)."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return -center[0], float(dist.max()) * 1.1


def _resolve_scale(width: int, resolution: int) -> float:
    """The reference's resolution rule (utils/camera_utils.py:19-46)."""
    if resolution in (1, 2, 4, 8):
        return float(resolution)
    if resolution == -1:
        return width / 1600.0 if width > 1600 else 1.0
    if resolution > 0:
        return float(resolution)
    return 1.0


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8 by antialiased bicubic
    interpolation (close to, not bit-equal with, the reference's PIL
    resize)."""
    x = torch.from_numpy(img).permute(2, 0, 1)[None].to(torch.float32)
    y = torch.nn.functional.interpolate(x, size=(h, w), mode="bicubic",
                                        antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


def load_colmap_scene(colmap_dir: str, images_dir: str = "images",
                      resolution: int = -1, eval_split: bool = False,
                      llffhold: int = 8, max_views: Optional[int] = None,
                      device="cuda") -> SceneData:
    device = resolve_device(device)
    cams, images, points = colmap_io.read_model(
        os.path.join(colmap_dir, "sparse", "0"))
    keys = sorted(images.keys(), key=lambda k: images[k].name)
    if max_views is not None:
        keys = keys[:max_views]

    cam_list: List[Camera] = []
    img_list: List[np.ndarray] = []
    centers = []
    for k in keys:
        im = images[k]
        cam = cams[im.camera_id]
        R_w2c = qvec2rotmat_wxyz(im.qvec)
        T = np.asarray(im.tvec, np.float64)
        # GS stores R transposed (CameraInfo convention,
        # dataset_readers.py:84-86): R = w2c.T, the cam-to-world rotation.
        R = R_w2c.T
        simple = cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL")
        fx = float(cam.params[0])
        fy = float(cam.params[0 if simple else 1])

        path = os.path.join(colmap_dir, images_dir, im.name)
        pix = read_png(path)
        if pix.ndim != 3:
            raise ValueError(f"{path}: a training image must be RGB or RGBA")
        pix = pix[..., :3]
        scale = _resolve_scale(pix.shape[1], resolution)
        w = round(pix.shape[1] / scale)
        h = round(pix.shape[0] / scale)
        if (w, h) != (pix.shape[1], pix.shape[0]):
            pix = _resize(pix, w, h)
        cam_list.append(make_camera(R, T, focal2fov(fx, cam.width),
                                    focal2fov(fy, cam.height), w, h,
                                    device=device))
        img_list.append((pix.astype(np.float32) / 255.0).transpose(2, 0, 1))
        centers.append(-R_w2c.T @ T)

    translate, radius = get_nerfpp_norm(np.asarray(centers))
    if points:
        xyz = np.stack([p.xyz for p in points.values()]).astype(np.float32)
        rgb = np.stack([p.rgb for p in points.values()]).astype(
            np.float32) / 255.0
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.float32)

    idx = list(range(len(cam_list)))
    if eval_split:
        test = [i for i in idx if i % llffhold == 0]
        train = [i for i in idx if i % llffhold != 0]
    else:
        train, test = idx, []
    return SceneData(cameras=cam_list, images=img_list, points=xyz,
                     colors=rgb, nerf_norm_radius=radius,
                     nerf_norm_translate=translate,
                     train_indices=train, test_indices=test)


def random_point_cloud_fallback(n: int, radius: float, seed: int = 0):
    """Blender-style random init when no SfM points exist
    (dataset_readers.py:221-230)."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((n, 3)).astype(np.float32) * 2.6 - 1.3) * radius
    rgb = rng.random((n, 3)).astype(np.float32)
    return xyz, rgb
