"""Per-Gaussian preprocessing: projection, EWA splat, conic, tile extents.

Port of the reference preprocess (gs2mesh_tpu ops/rasterizer/preprocess.py,
itself the CUDA preprocessCUDA semantics: near cull at z<=0.2, EWA cov2d
with the 1.3*tanfov clamp and +0.3 dilation, conic from the 2x2 inverse,
radius = ceil(3*sqrt(lambda_max)), alpha-aware per-axis tile rect).

``preprocess`` sends CUDA tensors to ``PreprocessFunction``: its forward
launches kernel P1 (``preprocess_forward_cuda``) and its backward kernel P2
(``preprocess_backward_cuda``), both in ``csrc/preprocess.cu``, one thread
per gaussian. CPU tensors, and the ``cov3d_precomp`` / ``colors_precomp``
routes on any device, run ``preprocess_plain``, differentiated by autograd.
``preprocess_plain`` is P1's plain version: every tensor expression keeps
the reference's flat (N,)-channel float-op order, since ``radius``,
``rect`` and ``tiles_touched`` come from ceil/floor of float expressions
and must decide identically, and P1 repeats that order op for op.
``preprocess_backward_plain`` is P2's plain version: the chain rule of the
same expressions written out by hand, with autograd's choices at every
branch (the ``where`` masks, ties of the FoV clamp, the SH clamp at 0).
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch

from gs2mesh_torch import _build
from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.core.sh import C0, C1, C2, C3, eval_sh, sh_to_rgb
from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.emit import _check_cuda


class Preprocessed(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coords
    depths: torch.Tensor    # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse cov2d upper triangle (a, b, c)
    rgb: torch.Tensor       # (N, 3)
    opacity: torch.Tensor   # (N,)
    radius: torch.Tensor    # (N,) int32 pixel radius (0 = culled)
    rect: torch.Tensor      # (N, 4) int32 tile rect x0, y0, x1, y1 (exclusive)
    tiles_touched: torch.Tensor  # (N,) int32


# The upper triangle of a symmetric 3x3 in cov3d_entries' order: the
# covariance entries (k, l), and the pairs (i, j) of view-matrix columns of
# the six quadratic forms q_ij = w_i^T Sigma w_j.
_UPPER = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _rot_rows(q):
    """Quaternion (w, x, y, z) -> the 9 rotation entries as (N,) channels."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
            (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
            (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)))


def quat_to_rotmat(q):
    """(..., 4) normalized quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    return torch.stack([torch.stack(row, -1) for row in _rot_rows(q)], -2)


def _sig(R, s2, k, l):
    return (R[k][0] * R[l][0] * s2[0] + R[k][1] * R[l][1] * s2[1]
            + R[k][2] * R[l][2] * s2[2])


def cov3d_entries(scales, rotations, scale_modifier: float = 1.0):
    """(N,3) scales + (N,4) quats -> the 6 unique entries of R S S R^T."""
    R = _rot_rows(rotations)
    s2 = [(scales[:, m] * scale_modifier) ** 2 for m in range(3)]
    return tuple(_sig(R, s2, k, l) for k, l in _UPPER)


def build_cov3d(scales, rotations, scale_modifier: float = 1.0):
    """(N, 3) scales + (N, 4) quats -> (N, 3, 3) world covariance."""
    sxx, sxy, sxz, syy, syz, szz = cov3d_entries(scales, rotations,
                                                 scale_modifier)
    return torch.stack([torch.stack([sxx, sxy, sxz], -1),
                        torch.stack([sxy, syy, syz], -1),
                        torch.stack([sxz, syz, szz], -1)], dim=-2)


def ndc_to_pix(v, size: int):
    return ((v + 1.0) * size - 1.0) * 0.5


def _qform(wa, wb, sig):
    sxx, sxy, sxz, syy, syz, szz = sig
    return (wa[0] * wb[0] * sxx + wa[1] * wb[1] * syy
            + wa[2] * wb[2] * szz
            + (wa[0] * wb[1] + wa[1] * wb[0]) * sxy
            + (wa[0] * wb[2] + wa[2] * wb[0]) * sxz
            + (wa[1] * wb[2] + wa[2] * wb[1]) * syz)


def _clamp_fov(u, lim):
    return torch.minimum(torch.maximum(u, -lim), lim)


def _terms(means3d, sig, camera: Camera, cfg: RasterizerConfig):
    """The float intermediates of the projection and the EWA splat, as (N,)
    channels (0-d tensors for the camera's), in the reference's op order;
    ``sig`` the 6 covariance entries."""
    t = SimpleNamespace()
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    Wv, Pm = camera.world_view, camera.full_proj

    def affine(M, k):
        return mx * M[0, k] + my * M[1, k] + mz * M[2, k] + M[3, k]

    t.view_x, t.view_y, t.depths = affine(Wv, 0), affine(Wv, 1), affine(Wv, 2)
    t.clip_x, t.clip_y, t.clip_w = affine(Pm, 0), affine(Pm, 1), affine(Pm, 3)
    t.p_w = 1.0 / (t.clip_w + 1e-7)
    t.valid = t.depths > cfg.near

    # EWA projection to the 2D covariance (forward.cu:74-113), expanded.
    t.fx, t.fy = camera.focal_x, camera.focal_y
    t.tz = torch.where(t.valid, t.depths, 1.0)
    t.inv_tz = 1.0 / t.tz
    t.limx = cfg.fov_clamp * camera.tan_fovx
    t.limy = cfg.fov_clamp * camera.tan_fovy
    t.ux, t.uy = t.view_x * t.inv_tz, t.view_y * t.inv_tz
    t.mx, t.my = _clamp_fov(t.ux, t.limx), _clamp_fov(t.uy, t.limy)
    t.txz, t.tyz = t.mx * t.tz, t.my * t.tz

    t.a0 = t.fx * t.inv_tz
    t.c0 = -t.fx * t.txz * t.inv_tz * t.inv_tz
    t.a1 = t.fy * t.inv_tz
    t.c1 = -t.fy * t.tyz * t.inv_tz * t.inv_tz

    W3 = Wv[:3, :3].T
    t.w = tuple((W3[i, 0], W3[i, 1], W3[i, 2]) for i in range(3))
    q00, q01, q02, q11, q12, q22 = (_qform(t.w[i], t.w[j], sig)
                                    for i, j in _UPPER)
    t.q = (q00, q01, q02, q11, q12, q22)
    a0, c0, a1, c1 = t.a0, t.c0, t.a1, t.c1
    t.cov_a = (a0 * a0 * q00 + 2.0 * a0 * c0 * q02 + c0 * c0 * q22
               + cfg.dilation)
    t.cov_b = a0 * a1 * q01 + a0 * c1 * q02 + c0 * a1 * q12 + c0 * c1 * q22
    t.cov_c = (a1 * a1 * q11 + 2.0 * a1 * c1 * q12 + c1 * c1 * q22
               + cfg.dilation)

    t.det = t.cov_a * t.cov_c - t.cov_b * t.cov_b
    t.inv_det = 1.0 / torch.where(t.det == 0.0, 1.0, t.det)
    return t


def _sh_dirs(means3d, camera: Camera):
    """Unit view directions (N, 3) and the unnormalised ones."""
    d = means3d - camera.cam_center[None, :]
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True), d


def preprocess_plain(means3d, scales, rotations, opacities, shs,
                     camera: Camera, sh_degree: int,
                     cfg: RasterizerConfig = RasterizerConfig(),
                     scale_modifier: float = 1.0, cov3d_precomp=None,
                     colors_precomp=None,
                     float_type: torch.dtype = torch.float32) -> Preprocessed:
    """Kernel P1's plain version (and the precomp routes), in PyTorch ops;
    autograd differentiates it. Same contract as ``preprocess``; the
    arithmetic is float32, as in the JAX package, unless ``float_type``
    asks for float64 (for gradient checks, with a float64 camera)."""
    N = means3d.shape[0]
    f32 = float_type
    means3d = means3d.to(f32)

    if cov3d_precomp is None:
        sig = cov3d_entries(scales, rotations, scale_modifier)
    else:
        sig = (cov3d_precomp[:, 0, 0], cov3d_precomp[:, 0, 1],
               cov3d_precomp[:, 0, 2], cov3d_precomp[:, 1, 1],
               cov3d_precomp[:, 1, 2], cov3d_precomp[:, 2, 2])
    t = _terms(means3d, sig, camera, cfg)
    cov_a, cov_b, cov_c, det = t.cov_a, t.cov_b, t.cov_c, t.det
    valid = t.valid & (det != 0.0)
    conic = torch.stack([cov_c * t.inv_det, -cov_b * t.inv_det,
                         cov_a * t.inv_det], -1)

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

    mean_x = ndc_to_pix(t.clip_x * t.p_w, camera.width)
    mean_y = ndc_to_pix(t.clip_y * t.p_w, camera.height)
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # Tile rect (getRect, auxiliary.h:46-56). Clamping the float before the
    # int conversion gives the reference's clipped result for every finite
    # input without an out-of-range float->int cast.
    gx, gy = cfg.grid_size(camera.width, camera.height)
    tf = float(cfg.tile)

    def tile_edge(v, hi):
        return torch.clamp(torch.floor(v / tf), 0, hi).to(torch.int32)

    x0 = tile_edge(mean_x - rect_rx, gx)
    y0 = tile_edge(mean_y - rect_ry, gy)
    x1 = tile_edge(mean_x + rect_rx + tf - 1, gx)
    y1 = tile_edge(mean_y + rect_ry + tf - 1, gy)
    tiles = (x1 - x0) * (y1 - y0)
    valid = valid & (tiles > 0)

    if colors_precomp is None:
        rgb = sh_to_rgb(sh_degree, shs, _sh_dirs(means3d, camera)[0])
    else:
        rgb = colors_precomp

    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    tiles_touched = torch.where(valid & emit_ok, tiles, 0).to(torch.int32)
    rect = torch.stack([x0, y0, x1, y1], dim=-1)

    return Preprocessed(means2d=means2d, depths=t.depths, conic=conic,
                        rgb=rgb, opacity=op_n, radius=radius, rect=rect,
                        tiles_touched=tiles_touched)


def _sh_basis(deg: int, x, y, z):
    """The SH basis as ``eval_sh`` multiplies it into each coefficient
    (signs included), and its x, y and z derivatives: lists of (N,)
    channels, or None where a term does not depend on that coordinate."""
    basis, dx, dy, dz = [torch.full_like(x, C0)], [None], [None], [None]
    if deg > 0:
        basis += [-(C1 * y), C1 * z, -(C1 * x)]
        dx += [None, None, torch.full_like(x, -C1)]
        dy += [torch.full_like(x, -C1), None, None]
        dz += [None, torch.full_like(x, C1), None]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
        dx += [C2[0] * y, None, -2.0 * C2[2] * x, C2[3] * z,
               2.0 * C2[4] * x]
        dy += [C2[0] * x, C2[1] * z, -2.0 * C2[2] * y, None,
               -2.0 * C2[4] * y]
        dz += [None, C2[1] * y, 4.0 * C2[2] * z, C2[3] * x, None]
    if deg > 2:
        basis += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                  C3[2] * y * (4.0 * zz - xx - yy),
                  C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3.0 * yy)]
        dx += [6.0 * C3[0] * xy, C3[1] * yz, -2.0 * C3[2] * xy,
               -6.0 * C3[3] * xz, C3[4] * (4.0 * zz - 3.0 * xx - yy),
               2.0 * C3[5] * xz, 3.0 * C3[6] * (xx - yy)]
        dy += [3.0 * C3[0] * (xx - yy), C3[1] * xz,
               C3[2] * (4.0 * zz - xx - 3.0 * yy), -6.0 * C3[3] * yz,
               -2.0 * C3[4] * xy, -2.0 * C3[5] * yz, -6.0 * C3[6] * xy]
        dz += [None, C3[1] * xy, 8.0 * C3[2] * yz,
               C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy), 8.0 * C3[4] * xz,
               C3[5] * (xx - yy), None]
    return basis, dx, dy, dz


def _min_max_grad(g, u, lim):
    """Autograd's gradient through minimum(maximum(u, -lim), lim) (ties
    split in halves) with respect to u."""
    v = torch.maximum(u, -lim)
    g = torch.where(v == lim, g / 2, g).masked_fill(v > lim, 0.0)
    return torch.where(u == -lim, g / 2, g).masked_fill(u < -lim, 0.0)


def preprocess_backward_plain(means3d, scales, rotations, shs,
                              camera: Camera, sh_degree: int,
                              cfg: RasterizerConfig, scale_modifier: float,
                              dmeans2d, dconic, drgb,
                              float_type: torch.dtype = torch.float32):
    """Kernel P2's plain version: the gradients (dmeans3d (N, 3), dscales
    (N, 3), drotations (N, 4), dshs (N, K, 3)) of ``preprocess_plain``'s
    means2d, conic and rgb against their cotangents, written out by the
    chain rule over (N,) channels with the forward's intermediates
    recomputed. SH coefficients past (sh_degree + 1)^2 get zero.
    ``float_type`` as in ``preprocess_plain``."""
    f32 = float_type
    means3d, scales, rotations = (x.to(f32) for x in (means3d, scales,
                                                      rotations))
    R = _rot_rows(rotations)
    s = [scales[:, m] * scale_modifier for m in range(3)]
    s2 = [v ** 2 for v in s]
    sig = tuple(_sig(R, s2, k, l) for k, l in _UPPER)
    t = _terms(means3d, sig, camera, cfg)
    a0, c0, a1, c1 = t.a0, t.c0, t.a1, t.c1
    q00, q01, q02, q11, q12, q22 = t.q

    # conic = (cov_c, -cov_b, cov_a) / det
    gA, gB, gC = dconic[:, 0], dconic[:, 1], dconic[:, 2]
    g_inv = gA * t.cov_c - gB * t.cov_b + gC * t.cov_a
    g_det = torch.where(t.det == 0.0, 0.0, -g_inv * (t.inv_det * t.inv_det))
    g_ca = gC * t.inv_det + g_det * t.cov_c
    g_cb = -gB * t.inv_det - 2.0 * g_det * t.cov_b
    g_cc = gA * t.inv_det + g_det * t.cov_a

    # cov2d -> (a0, c0, a1, c1) and the six quadratic forms
    g_a0 = g_ca * (2.0 * a0 * q00 + 2.0 * c0 * q02) + g_cb * (a1 * q01
                                                              + c1 * q02)
    g_c0 = g_ca * (2.0 * a0 * q02 + 2.0 * c0 * q22) + g_cb * (a1 * q12
                                                              + c1 * q22)
    g_a1 = g_cc * (2.0 * a1 * q11 + 2.0 * c1 * q12) + g_cb * (a0 * q01
                                                              + c0 * q12)
    g_c1 = g_cc * (2.0 * a1 * q12 + 2.0 * c1 * q22) + g_cb * (a0 * q02
                                                              + c0 * q22)
    g_q = (g_ca * a0 * a0, g_cb * a0 * a1,
           g_ca * 2.0 * a0 * c0 + g_cb * a0 * c1, g_cc * a1 * a1,
           g_cb * c0 * a1 + g_cc * 2.0 * a1 * c1,
           g_ca * c0 * c0 + g_cb * c0 * c1 + g_cc * c1 * c1)

    # q_ij = w_i^T Sigma w_j -> the six covariance entries
    g_sig = [0.0] * 6
    for gq, (i, j) in zip(g_q, _UPPER):
        wa, wb = t.w[i], t.w[j]
        coef = (wa[0] * wb[0], wa[0] * wb[1] + wa[1] * wb[0],
                wa[0] * wb[2] + wa[2] * wb[0], wa[1] * wb[1],
                wa[1] * wb[2] + wa[2] * wb[1], wa[2] * wb[2])
        for e in range(6):
            g_sig[e] = g_sig[e] + gq * coef[e]
    g_xx, g_xy, g_xz, g_yy, g_yz, g_zz = g_sig

    # Sigma = R diag(s2) R^T -> R and the scales
    Gs = ((2.0 * g_xx, g_xy, g_xz), (g_xy, 2.0 * g_yy, g_yz),
          (g_xz, g_yz, 2.0 * g_zz))
    g_R = [[s2[m] * (Gs[k][0] * R[0][m] + Gs[k][1] * R[1][m]
                     + Gs[k][2] * R[2][m]) for m in range(3)]
           for k in range(3)]
    g_scales = []
    for m in range(3):
        g_s2 = (g_xx * R[0][m] * R[0][m] + g_yy * R[1][m] * R[1][m]
                + g_zz * R[2][m] * R[2][m] + g_xy * R[0][m] * R[1][m]
                + g_xz * R[0][m] * R[2][m] + g_yz * R[1][m] * R[2][m])
        g_scales.append(g_s2 * (2.0 * s[m]) * scale_modifier)

    # R(q) -> q (w, x, y, z)
    r, x, y, z = (rotations[:, i] for i in range(4))
    (g00, g01, g02), (g10, g11, g12), (g20, g21, g22) = g_R
    g_rot = torch.stack([
        2.0 * (-z * g01 + y * g02 + z * g10 - x * g12 - y * g20 + x * g21),
        2.0 * (y * g01 + z * g02 + y * g10 - 2.0 * x * g11 - r * g12
               + z * g20 + r * g21 - 2.0 * x * g22),
        2.0 * (-2.0 * y * g00 + x * g01 + r * g02 + x * g10 + z * g12
               - r * g20 + z * g21 - 2.0 * y * g22),
        2.0 * (-2.0 * z * g00 - r * g01 + x * g02 + r * g10 - 2.0 * z * g11
               + y * g12 + x * g20 + y * g21)], -1)

    # (a0, c0, a1, c1) -> inv_tz, the clamped tangents and the view x / y
    fx, fy, inv_tz = t.fx, t.fy, t.inv_tz
    g_txz = g_c0 * -fx * inv_tz * inv_tz
    g_tyz = g_c1 * -fy * inv_tz * inv_tz
    g_inv_tz = (g_a0 * fx + g_a1 * fy
                + g_c0 * -fx * t.txz * 2.0 * inv_tz
                + g_c1 * -fy * t.tyz * 2.0 * inv_tz)
    g_ux = _min_max_grad(g_txz * t.tz, t.ux, t.limx)
    g_uy = _min_max_grad(g_tyz * t.tz, t.uy, t.limy)
    g_view_x = g_ux * inv_tz
    g_view_y = g_uy * inv_tz
    g_inv_tz = g_inv_tz + g_ux * t.view_x + g_uy * t.view_y
    g_tz = g_txz * t.mx + g_tyz * t.my - g_inv_tz * (inv_tz * inv_tz)
    g_depth = torch.where(t.valid, g_tz, 0.0)

    # means2d = ndc_to_pix(clip_xy * p_w)
    g_nx = dmeans2d[:, 0] * 0.5 * camera.width
    g_ny = dmeans2d[:, 1] * 0.5 * camera.height
    g_pw = g_nx * t.clip_x + g_ny * t.clip_y
    g_clip = (g_nx * t.p_w, g_ny * t.p_w, -g_pw * (t.p_w * t.p_w))

    Wv, Pm = camera.world_view, camera.full_proj
    g_means = torch.stack([
        Wv[k, 0] * g_view_x + Wv[k, 1] * g_view_y + Wv[k, 2] * g_depth
        + Pm[k, 0] * g_clip[0] + Pm[k, 1] * g_clip[1] + Pm[k, 3] * g_clip[2]
        for k in range(3)], -1)

    # rgb = max(eval_sh(shs, dirs) + 0.5, 0)
    dirs, d = _sh_dirs(means3d, camera)
    shs = shs.to(f32)
    basis, bx, by, bz = _sh_basis(sh_degree, dirs[:, 0], dirs[:, 1],
                                  dirs[:, 2])
    g_raw = torch.where(eval_sh(sh_degree, shs, dirs) + 0.5 >= 0.0, drgb,
                        0.0)
    g_shs = torch.zeros_like(shs)
    for k, b in enumerate(basis):
        g_shs[:, k] = g_raw * b[:, None]
    if sh_degree > 0:
        g_dirs = torch.stack([
            sum((g_raw * shs[:, k]).sum(-1) * dk
                for k, dk in enumerate(dd) if dk is not None)
            for dd in (bx, by, bz)], -1)
        n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        g_n = ((-g_dirs * d) / (n * n)).sum(-1, keepdim=True)
        g_means = g_means + g_dirs / n + d * (g_n / n)
    return g_means, torch.stack(g_scales, -1), g_rot, g_shs


@functools.lru_cache(maxsize=None)
def _p1():
    fn = _build.library("preprocess").gs_preprocess_forward
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _p2():
    fn = _build.library("preprocess").gs_preprocess_backward
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _camera_args(camera: Camera, **tensors):
    """The camera's device tensors in the kernels' order, checked beside
    the gaussians' ones (the caller keeps them alive over the launch).
    Nothing is read on the host."""
    cam = dict(world_view=(camera.world_view.contiguous(), torch.float32,
                           (4, 4)),
               full_proj=(camera.full_proj.contiguous(), torch.float32,
                          (4, 4)),
               cam_center=(camera.cam_center.contiguous(), torch.float32,
                           (3,)),
               tan_fovx=(camera.tan_fovx.contiguous(), torch.float32, ()),
               tan_fovy=(camera.tan_fovy.contiguous(), torch.float32, ()))
    _check_cuda(**tensors, **cam)
    return [x for x, _, _ in cam.values()]


def _sh_shape(shs, n: int, sh_degree: int) -> int:
    K = shs.shape[1] if shs.dim() == 3 else -1
    if not 0 <= sh_degree <= 3 or K < (sh_degree + 1) ** 2:
        raise ValueError(f"shs {tuple(shs.shape)} for SH degree {sh_degree}")
    if n >= 2 ** 31 // max(3 * K, 4):
        raise ValueError(f"unsupported gaussian count {n}")
    return K


def preprocess_forward_cuda(means3d, scales, rotations, opacities, shs,
                            camera: Camera, sh_degree: int,
                            cfg: RasterizerConfig, scale_modifier: float):
    """Kernel P1: one thread per gaussian computes ``preprocess_plain``'s
    outputs in its op order (bit-equal on the card but for rgb, whose
    direction norm and SH sums may round apart in the last bit). Takes
    float32 contiguous (N, 3) means3d / scales, (N, 4) rotations, (N,)
    opacities and (N, K, 3) shs. Returns (means2d, depths, conic, rgb,
    radius, rect, tiles_touched)."""
    N = means3d.shape[0]
    K = _sh_shape(shs, N, sh_degree)
    cam = _camera_args(camera, means3d=(means3d, torch.float32, (N, 3)),
                       scales=(scales, torch.float32, (N, 3)),
                       rotations=(rotations, torch.float32, (N, 4)),
                       opacities=(opacities, torch.float32, (N,)),
                       shs=(shs, torch.float32, (N, K, 3)))
    dev = means3d.device
    f32, i32 = torch.float32, torch.int32
    out = (torch.empty((N, 2), dtype=f32, device=dev),
           torch.empty((N,), dtype=f32, device=dev),
           torch.empty((N, 3), dtype=f32, device=dev),
           torch.empty((N, 3), dtype=f32, device=dev),
           torch.empty((N,), dtype=i32, device=dev),
           torch.empty((N, 4), dtype=i32, device=dev),
           torch.empty((N,), dtype=i32, device=dev))
    if N == 0:
        return out
    gx, gy = cfg.grid_size(camera.width, camera.height)
    err = _p1()(means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
                opacities.data_ptr(), shs.data_ptr(),
                *(x.data_ptr() for x in cam), N, K, sh_degree,
                camera.width, camera.height, cfg.tile, gx, gy,
                scale_modifier, cfg.near, cfg.fov_clamp, cfg.dilation,
                *(x.data_ptr() for x in out),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error "
                           f"{err}")
    preprocess_forward_cuda.launches += 1
    return out


preprocess_forward_cuda.launches = 0


def preprocess_backward_cuda(means3d, scales, rotations, shs,
                             camera: Camera, sh_degree: int,
                             cfg: RasterizerConfig, scale_modifier: float,
                             dmeans2d, dconic, drgb):
    """Kernel P2: one thread per gaussian recomputes the forward's
    intermediates and writes the gradients of ``preprocess_backward_plain``
    in its op order (no atomics: every run is bit-identical). Inputs as
    preprocess_forward_cuda's, cotangents float32 (N, 2), (N, 3), (N, 3).
    Returns (dmeans3d, dscales, drotations, dshs)."""
    N = means3d.shape[0]
    K = _sh_shape(shs, N, sh_degree)
    dmeans2d, dconic, drgb = (x.contiguous() for x in (dmeans2d, dconic,
                                                       drgb))
    cam = _camera_args(camera, means3d=(means3d, torch.float32, (N, 3)),
                       scales=(scales, torch.float32, (N, 3)),
                       rotations=(rotations, torch.float32, (N, 4)),
                       shs=(shs, torch.float32, (N, K, 3)),
                       dmeans2d=(dmeans2d, torch.float32, (N, 2)),
                       dconic=(dconic, torch.float32, (N, 3)),
                       drgb=(drgb, torch.float32, (N, 3)))
    out = tuple(torch.empty_like(x) for x in (means3d, scales, rotations,
                                              shs))
    if N == 0:
        return out
    dev = means3d.device
    err = _p2()(means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
                shs.data_ptr(), *(x.data_ptr() for x in cam),
                dmeans2d.data_ptr(), dconic.data_ptr(),
                drgb.data_ptr(), N, K, sh_degree, camera.width,
                camera.height, scale_modifier, cfg.near, cfg.fov_clamp,
                cfg.dilation, *(x.data_ptr() for x in out),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess backward kernel launch failed: CUDA "
                           f"error {err}")
    preprocess_backward_cuda.launches += 1
    return out


preprocess_backward_cuda.launches = 0


def preprocess_kernel_info(which: str) -> dict:
    """Registers per thread, static shared memory bytes and blocks per SM
    (occupancy API) of ``"P1"`` or ``"P2"`` on the current card."""
    fn = _build.library("preprocess").gs_preprocess_kernel_info
    return _build.kernel_info(fn, {"P1": 1, "P2": 2}[which])


class PreprocessFunction(torch.autograd.Function):
    """(means3d, scales, rotations, opacities, shs) -> (means2d, depths,
    conic, rgb, radius, rect, tiles_touched) through kernel P1, and back
    through kernel P2 from the cotangents of means2d, conic and rgb.
    depths and the integer outputs are not differentiable; opacities reach
    only the integer outputs here (``Preprocessed.opacity`` is the input
    itself, outside this function)."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, shs,
                camera: Camera, sh_degree: int, cfg: RasterizerConfig,
                scale_modifier: float):
        out = preprocess_forward_cuda(means3d, scales, rotations, opacities,
                                      shs, camera, sh_degree, cfg,
                                      scale_modifier)
        ctx.save_for_backward(means3d, scales, rotations, shs)
        ctx.args = (camera, sh_degree, cfg, scale_modifier)
        ctx.mark_non_differentiable(out[1], *out[4:])
        return out

    @staticmethod
    def backward(ctx, dmeans2d, _depths, dconic, drgb, *_ints):
        means3d, scales, rotations, shs = ctx.saved_tensors
        g = preprocess_backward_cuda(means3d, scales, rotations, shs,
                                     *ctx.args, dmeans2d, dconic, drgb)
        return g[0], g[1], g[2], None, g[3], None, None, None, None


def preprocess(means3d, scales, rotations, opacities, shs, camera: Camera,
               sh_degree: int, cfg: RasterizerConfig = RasterizerConfig(),
               scale_modifier: float = 1.0, cov3d_precomp=None,
               colors_precomp=None) -> Preprocessed:
    """Kernels P1 / P2 for CUDA tensors, the plain version for CPU tensors
    and for the precomp routes. cov3d_precomp: optional (N, 3, 3) world
    covariances, used in place of the scales and rotations (its upper
    triangle is read); colors_precomp: optional (N, 3) colours, used in
    place of the SH evaluation."""
    dev = means3d.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu" or cov3d_precomp is not None \
            or colors_precomp is not None:
        return preprocess_plain(means3d, scales, rotations, opacities, shs,
                                camera, sh_degree, cfg, scale_modifier,
                                cov3d_precomp, colors_precomp)
    return preprocess_fused(means3d, scales, rotations, opacities, shs,
                            camera, sh_degree, cfg, scale_modifier)


def preprocess_fused(means3d, scales, rotations, opacities, shs,
                     camera: Camera, sh_degree: int,
                     cfg: RasterizerConfig = RasterizerConfig(),
                     scale_modifier: float = 1.0) -> Preprocessed:
    """``PreprocessFunction`` on float32 contiguous copies of the inputs
    (no copy where they already are)."""
    N = means3d.shape[0]
    f32 = torch.float32
    op_n = opacities.reshape(N).to(f32)
    means2d, depths, conic, rgb, radius, rect, tiles = \
        PreprocessFunction.apply(*(x.to(f32).contiguous() for x in (
            means3d, scales, rotations, op_n, shs)), camera, sh_degree, cfg,
            float(scale_modifier))
    return Preprocessed(means2d=means2d, depths=depths, conic=conic, rgb=rgb,
                        opacity=op_n, radius=radius, rect=rect,
                        tiles_touched=tiles)
