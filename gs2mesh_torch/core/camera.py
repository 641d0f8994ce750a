"""Camera model: GS view/projection conventions as a dataclass of tensors.

Same assembly as the reference (gaussian-splatting scene/cameras.py and
utils/graphics_utils.py), built in float64 numpy and stored as float32
tensors:

  * ``world_view`` is the TRANSPOSE of the world-to-view matrix (row-vector
    convention: ``p_view = p_world @ world_view``).
  * ``full_proj = world_view @ proj^T`` likewise operates on row vectors.
  * NDC -> pixel: ``((v + 1) * S - 1) / 2``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gs2mesh_torch import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """World-to-view 4x4 (NOT transposed) from GS-convention (R, T): ``R`` is
    the camera-to-world rotation, ``t`` the world-to-view translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + np.asarray(translate)) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """GS perspective projection 4x4 (NOT transposed), w = view z."""
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """Matrices stored TRANSPOSED (row-vector convention), exactly like the
    reference's ``world_view_transform`` / ``full_proj_transform``."""

    world_view: torch.Tensor   # (4, 4) = W2V^T
    full_proj: torch.Tensor    # (4, 4) = W2V^T @ P^T
    cam_center: torch.Tensor   # (3,)
    tan_fovx: torch.Tensor     # () float32
    tan_fovy: torch.Tensor     # () float32
    width: int = 0
    height: int = 0

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)

    @property
    def device(self) -> torch.device:
        return self.world_view.device


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                znear: float = 0.01, zfar: float = 100.0,
                translate=(0.0, 0.0, 0.0), scale: float = 1.0,
                device="cuda") -> Camera:
    """Camera from GS-convention (R, T) + FoVs, on ``device``."""
    device = resolve_device(device)
    w2v = world_to_view(R, T, translate, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    world_view = w2v.T
    full_proj = world_view @ proj.T
    cam_center = np.linalg.inv(world_view)[3, :3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(world_view=t(world_view), full_proj=t(full_proj),
                  cam_center=t(cam_center),
                  tan_fovx=t(math.tan(fovx / 2.0)),
                  tan_fovy=t(math.tan(fovy / 2.0)),
                  width=int(width), height=int(height))


def camera_from_euler(rot_deg, pos, fx: float, fy: float,
                      width: int, height: int, device="cuda", **kw) -> Camera:
    """Camera from the pipeline's Euler-angle camera dicts."""
    from gs2mesh_torch.core.transforms import convert_R_T_to_GS

    R, T = convert_R_T_to_GS(rot_deg, pos)
    return make_camera(R, T, focal2fov(fx, width), focal2fov(fy, height),
                       width, height, device=device, **kw)
