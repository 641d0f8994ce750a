"""Pose / transform utilities (host-side numpy).

The port's own copy of the reference's conventions
(gs2mesh_utils/transformation_utils.py): Euler-angle camera descriptions,
the OpenCV<->GS axis flips and the stereo right-camera pose, with the
quaternion, projection and sphere-fit helpers the SfM stage, the renderer
and the evaluations use.
"""

from __future__ import annotations

import numpy as np

ZERO = 1e-7


def fix_zero(x):
    """Snap numerically-tiny values to exactly zero (parity helper)."""
    x = np.asarray(x)
    return np.where(np.abs(x) < ZERO, 0.0, x)


def eul2rotm(rot_deg) -> np.ndarray:
    """Euler angles (degrees, XYZ applied as Rz@Ry@Rx) -> 3x3 rotation."""
    rx, ry, rz = np.radians(np.asarray(rot_deg, dtype=np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    return fix_zero(Rz @ Ry @ Rx).astype(np.float32)


def rotm2eul(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> Euler angles in degrees (inverse of eul2rotm)."""
    R = np.asarray(R, dtype=np.float32)
    sy = float(np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2))
    if sy >= 1e-6:
        x = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(-R[2, 0], sy)
        z = np.arctan2(R[1, 0], R[0, 0])
    else:
        x = np.arctan2(-R[1, 2], R[1, 1])
        y = np.arctan2(-R[2, 0], sy)
        z = 0.0
    return fix_zero(np.degrees([x, y, z])).astype(np.float64)


def RT_from_rot_pos(rot_deg, pos) -> np.ndarray:
    """Camera-to-world 4x4 from Euler rotation + position, with the GS-style
    sign flip of the 2nd/3rd rotation columns."""
    R = eul2rotm(rot_deg).copy()
    R[:, 1:] *= -1
    RT = np.eye(4, dtype=np.float64)
    RT[:3, :3] = R
    RT[:3, 3] = np.asarray(pos, dtype=np.float64)
    return RT


def convert_R_T_to_GS(rot_deg, pos):
    """Euler rotation + camera position -> (R, T) in the Gaussian-Splatting
    camera convention (world-to-view with flipped y/z)."""
    Rt = np.eye(4, dtype=np.float64)
    Rt[:3, :3] = eul2rotm(rot_deg)
    Rt[:3, 3] = np.asarray(pos, dtype=np.float64)
    W2C = np.linalg.inv(Rt)
    GS_T = W2C[:3, 3].copy()
    GS_T[1:] *= -1
    GS_R = W2C[:3, :3].T.copy()
    GS_R[:, 1:] *= -1
    return GS_R.astype(np.float32), GS_T.astype(np.float32)


def calculate_right_camera_pose(rot_left_deg, pos_left, baseline: float):
    """Stereo right camera: same rotation, position offset by R @ [b, 0, 0]."""
    R = eul2rotm(rot_left_deg)
    offset = R @ np.array([baseline, 0.0, 0.0], dtype=np.float64)
    T_right = np.asarray(pos_left, dtype=np.float64) + offset
    rot = np.asarray(rot_left_deg, dtype=np.float64)
    return tuple(rot.tolist()), tuple(fix_zero(T_right).tolist())


def intrinsic_from_camera_params(p: dict) -> np.ndarray:
    """{'fx','fy','cx','cy'} -> 3x3 K matrix."""
    return np.array(
        [[p["fx"], 0.0, p["cx"]], [0.0, p["fy"], p["cy"]], [0.0, 0.0, 1.0]]
    )


def depth_image_to_point_cloud(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Backproject a depth image into camera-space 3D points (H*W, 3)."""
    h, w = depth.shape
    i, j = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    pix = np.stack([i, j, np.ones_like(i)], axis=-1).reshape(-1, 3)
    pts = (np.linalg.inv(K) @ pix.T) * depth.reshape(-1)
    return pts.T


def project_points_to_image(points: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Project camera-space 3D points to pixel coordinates (N, 2)."""
    p = (K @ points.T).T
    return p[:, :2] / p[:, 2:3]


def transform_points(points: np.ndarray, R: np.ndarray, T: np.ndarray) -> np.ndarray:
    return points @ R.T + T


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), scipy convention."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_quat()


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(q).as_matrix()


def qvec2rotmat_wxyz(qvec) -> np.ndarray:
    """COLMAP-style (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = np.asarray(qvec, dtype=np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP-style (w, x, y, z) quaternion."""
    q = matrix_to_quaternion(R)  # x, y, z, w
    return np.array([q[3], q[0], q[1], q[2]])


def sphere_fit_radius(points: np.ndarray) -> float:
    """Least-squares sphere fit; returns the radius.

    Used for stereo-baseline selection on non-360 scenes
    (reference renderer_utils.py:162-169). The start point is the points'
    mean taken as the JAX package's renderer stage takes it (one mean over
    the rows), so its baselines are bit-equal; the JAX package's own
    ``sphere_fit_radius`` takes each coordinate's mean apart, which can
    round the last bit otherwise.
    """
    from scipy.optimize import least_squares

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    x0 = np.array([*np.mean(points, axis=0), 1.0])

    def residuals(p):
        return np.sqrt((x - p[0]) ** 2 + (y - p[1]) ** 2 + (z - p[2]) ** 2) - p[3]

    result = least_squares(residuals, x0)
    return float(result.x[3])


def get_shading(img: np.ndarray, eps: float) -> np.ndarray:
    """1/|grad| shading of a (H, W) image in float64 (the stereo stage's
    diagnostic, reference stereo_utils.py:226-240): 3x3 Sobel gradients as
    ``cv2.Sobel(img, cv2.CV_64F, 1, 0)`` and ``(.., 0, 1)`` give them, with
    cv2's default border (BORDER_REFLECT_101, numpy's "reflect")."""
    p = np.pad(np.asarray(img, np.float64), 1, mode="reflect")
    smooth_y = p[:-2] + 2.0 * p[1:-1] + p[2:]                # (H, W+2)
    smooth_x = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]       # (H+2, W)
    gx = smooth_y[:, 2:] - smooth_y[:, :-2]
    gy = smooth_x[2:] - smooth_x[:-2]
    return 1.0 / np.sqrt(gx ** 2 + gy ** 2 + eps)
