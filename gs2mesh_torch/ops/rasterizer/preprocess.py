"""Per-Gaussian preprocessing: projection, EWA splat, conic, tile extents.

Plain PyTorch port of the reference preprocess (gs2mesh_tpu
ops/rasterizer/preprocess.py, itself the CUDA preprocessCUDA semantics:
near cull at z<=0.2, EWA cov2d with the 1.3*tanfov clamp and +0.3 dilation,
conic from the 2x2 inverse, radius = ceil(3*sqrt(lambda_max)), alpha-aware
per-axis tile rect). Every tensor expression keeps the reference's flat
(N,)-channel float-op order: ``radius``, ``rect`` and ``tiles_touched`` come
from ceil/floor of float expressions and must decide identically.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.core.sh import sh_to_rgb
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig


class Preprocessed(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coords
    depths: torch.Tensor    # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse cov2d upper triangle (a, b, c)
    rgb: torch.Tensor       # (N, 3)
    opacity: torch.Tensor   # (N,)
    radius: torch.Tensor    # (N,) int32 pixel radius (0 = culled)
    rect: torch.Tensor      # (N, 4) int32 tile rect x0, y0, x1, y1 (exclusive)
    tiles_touched: torch.Tensor  # (N,) int32


def _rot_rows(q):
    """Quaternion (w, x, y, z) -> the 9 rotation entries as (N,) channels."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
            (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
            (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)))


def quat_to_rotmat(q):
    """(..., 4) normalized quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    return torch.stack([torch.stack(row, -1) for row in _rot_rows(q)], -2)


def cov3d_entries(scales, rotations, scale_modifier: float = 1.0):
    """(N,3) scales + (N,4) quats -> the 6 unique entries of R S S R^T."""
    R = _rot_rows(rotations)
    s2 = [(scales[:, m] * scale_modifier) ** 2 for m in range(3)]

    def sig(k, l):
        return (R[k][0] * R[l][0] * s2[0] + R[k][1] * R[l][1] * s2[1]
                + R[k][2] * R[l][2] * s2[2])

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def build_cov3d(scales, rotations, scale_modifier: float = 1.0):
    """(N, 3) scales + (N, 4) quats -> (N, 3, 3) world covariance."""
    sxx, sxy, sxz, syy, syz, szz = cov3d_entries(scales, rotations,
                                                 scale_modifier)
    return torch.stack([torch.stack([sxx, sxy, sxz], -1),
                        torch.stack([sxy, syy, syz], -1),
                        torch.stack([sxz, syz, szz], -1)], dim=-2)


def ndc_to_pix(v, size: int):
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(means3d, scales, rotations, opacities, shs, camera: Camera,
               sh_degree: int, cfg: RasterizerConfig = RasterizerConfig(),
               scale_modifier: float = 1.0, cov3d_precomp=None,
               colors_precomp=None) -> Preprocessed:
    """cov3d_precomp: optional (N, 3, 3) world covariances, used in place of
    the scales and rotations (its upper triangle is read); colors_precomp:
    optional (N, 3) colours, used in place of the SH evaluation."""
    N = means3d.shape[0]
    f32 = torch.float32
    means3d = means3d.to(f32)
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    Wv = camera.world_view
    Pm = camera.full_proj

    def affine(M, k):
        return mx * M[0, k] + my * M[1, k] + mz * M[2, k] + M[3, k]

    view_x = affine(Wv, 0)
    view_y = affine(Wv, 1)
    depths = affine(Wv, 2)
    clip_x = affine(Pm, 0)
    clip_y = affine(Pm, 1)
    clip_w = affine(Pm, 3)
    p_w = 1.0 / (clip_w + 1e-7)

    valid = depths > cfg.near

    if cov3d_precomp is None:
        sxx, sxy, sxz, syy, syz, szz = cov3d_entries(scales, rotations,
                                                     scale_modifier)
    else:
        sxx, sxy, sxz = (cov3d_precomp[:, 0, 0], cov3d_precomp[:, 0, 1],
                         cov3d_precomp[:, 0, 2])
        syy, syz, szz = (cov3d_precomp[:, 1, 1], cov3d_precomp[:, 1, 2],
                         cov3d_precomp[:, 2, 2])

    # EWA projection to the 2D covariance (forward.cu:74-113), expanded.
    fx, fy = camera.focal_x, camera.focal_y
    tz = torch.where(valid, depths, 1.0)
    inv_tz = 1.0 / tz
    limx = cfg.fov_clamp * camera.tan_fovx
    limy = cfg.fov_clamp * camera.tan_fovy
    txz = torch.minimum(torch.maximum(view_x * inv_tz, -limx), limx) * tz
    tyz = torch.minimum(torch.maximum(view_y * inv_tz, -limy), limy) * tz

    a0 = fx * inv_tz
    c0 = -fx * txz * inv_tz * inv_tz
    a1 = fy * inv_tz
    c1 = -fy * tyz * inv_tz * inv_tz

    W3 = Wv[:3, :3].T

    def qform(wa, wb):
        return (wa[0] * wb[0] * sxx + wa[1] * wb[1] * syy
                + wa[2] * wb[2] * szz
                + (wa[0] * wb[1] + wa[1] * wb[0]) * sxy
                + (wa[0] * wb[2] + wa[2] * wb[0]) * sxz
                + (wa[1] * wb[2] + wa[2] * wb[1]) * syz)

    w0 = (W3[0, 0], W3[0, 1], W3[0, 2])
    w1 = (W3[1, 0], W3[1, 1], W3[1, 2])
    w2 = (W3[2, 0], W3[2, 1], W3[2, 2])
    q00 = qform(w0, w0)
    q01 = qform(w0, w1)
    q02 = qform(w0, w2)
    q11 = qform(w1, w1)
    q12 = qform(w1, w2)
    q22 = qform(w2, w2)

    cov_a = a0 * a0 * q00 + 2.0 * a0 * c0 * q02 + c0 * c0 * q22 + cfg.dilation
    cov_b = a0 * a1 * q01 + a0 * c1 * q02 + c0 * a1 * q12 + c0 * c1 * q22
    cov_c = a1 * a1 * q11 + 2.0 * a1 * c1 * q12 + c1 * c1 * q22 + cfg.dilation

    det = cov_a * cov_c - cov_b * cov_b
    valid = valid & (det != 0.0)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack([cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det],
                        -1)

    # Screen radius from the eigenvalues (forward.cu:227-232).
    mid = 0.5 * (cov_a + cov_c)
    sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda_max = mid + sq
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda_max, 0.0)))

    # Alpha-aware per-axis rect half-extents: a pixel composites iff
    # op * exp(-q(d)) >= 1/255, whose tight box has half-extents
    # sqrt(2 ln(255 op) cov_aa); min(3-sigma, extent) drops only pairs that
    # composite as exact zeros. The reported radius stays at 3-sigma.
    op_n = opacities.reshape(N).to(f32)
    log_term = torch.clamp_min(
        torch.log(torch.clamp_min(255.0 * op_n, 1e-12)), 0.0)
    rx_cut = torch.ceil(torch.sqrt(2.0 * torch.clamp_min(cov_a, 0.0)
                                   * log_term))
    ry_cut = torch.ceil(torch.sqrt(2.0 * torch.clamp_min(cov_c, 0.0)
                                   * log_term))
    rect_rx = torch.minimum(radius_f, rx_cut + 1.0)
    rect_ry = torch.minimum(radius_f, ry_cut + 1.0)
    emit_ok = op_n * 1.02 >= 1.0 / 255.0

    mean_x = ndc_to_pix(clip_x * p_w, camera.width)
    mean_y = ndc_to_pix(clip_y * p_w, camera.height)
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # Tile rect (getRect, auxiliary.h:46-56). Clamping the float before the
    # int conversion gives the reference's clipped result for every finite
    # input without an out-of-range float->int cast.
    gx, gy = cfg.grid_size(camera.width, camera.height)
    t = float(cfg.tile)

    def tile_edge(v, hi):
        return torch.clamp(torch.floor(v / t), 0, hi).to(torch.int32)

    x0 = tile_edge(mean_x - rect_rx, gx)
    y0 = tile_edge(mean_y - rect_ry, gy)
    x1 = tile_edge(mean_x + rect_rx + t - 1, gx)
    y1 = tile_edge(mean_y + rect_ry + t - 1, gy)
    tiles = (x1 - x0) * (y1 - y0)
    valid = valid & (tiles > 0)

    if colors_precomp is None:
        dirs = means3d - camera.cam_center[None, :]
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        rgb = sh_to_rgb(sh_degree, shs, dirs)
    else:
        rgb = colors_precomp

    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    tiles_touched = torch.where(valid & emit_ok, tiles, 0).to(torch.int32)
    rect = torch.stack([x0, y0, x1, y1], dim=-1)

    return Preprocessed(means2d=means2d, depths=depths, conic=conic, rgb=rgb,
                        opacity=op_n, radius=radius, rect=rect,
                        tiles_touched=tiles_touched)
