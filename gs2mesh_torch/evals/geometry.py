"""Point-cloud/mesh geometry primitives for the evaluation harnesses.

The port's copy of gs2mesh_tpu evals/geometry.py, host numpy/scipy code as
there; radius_downsample runs the port's native kernel (gs2mesh_torch.
native), which raises if it cannot be built. Replaces the Open3D/sklearn
machinery of the reference evaluators with numpy + scipy.spatial.cKDTree:
NN distances, voxel / radius downsampling, surface sampling at target
density (DTUeval grid scheme), Umeyama alignment, and point-to-point ICP.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


# ----------------------------------------------------------------- sampling

def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        density: float) -> np.ndarray:
    """Barycentric grid sampling at ~`density` spacing per triangle —
    the DTUeval scheme (eval.py:10-19, 52-72): per triangle, an (n1+1) x
    (n2+1) grid over the (v1, v2) edge basis keeps points with u+v < 1;
    returns the new points only (caller concatenates vertices)."""
    tri = vertices[faces]                                   # (F, 3, 3)
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    keep = area2 > 0
    v1, v2, tri, l1, l2, area2 = (a[keep] for a in
                                  (v1, v2, tri, l1, l2, area2))
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    out = []
    # group triangles by (n1, n2) so each group is one vectorized evaluation
    order = np.lexsort((n2, n1))
    n1o, n2o = n1[order], n2[order]
    boundaries = np.nonzero((np.diff(n1o) != 0) | (np.diff(n2o) != 0))[0] + 1
    groups = np.split(order, boundaries)
    for g in groups:
        a, b = int(n1[g[0]]), int(n2[g[0]])
        c = np.mgrid[:a + 1, :b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        k = c.reshape(2, -1).T
        k = k[k.sum(axis=-1) < 1]                           # (m, 2)
        if len(k) == 0:
            continue
        q = (v1[g][:, None, :] * k[None, :, :1]
             + v2[g][:, None, :] * k[None, :, 1:]
             + tri[g][:, None, 0, :])
        out.append(q.reshape(-1, 3))
    if not out:
        return np.zeros((0, 3))
    return np.concatenate(out, axis=0)


def area_weighted_samples(vertices: np.ndarray, faces: np.ndarray,
                          n_samples: int, seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples (stand-in for Open3D's
    Poisson-disk sampling in the MobileBrick harness; NN-distance metrics
    are insensitive to blue-noise vs uniform at this density)."""
    tri = vertices[faces]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(v1, v2), axis=-1)
    total = area.sum()
    if total <= 0 or len(faces) == 0:
        idx = np.random.default_rng(seed).permutation(len(vertices))
        return vertices[idx[:n_samples]]
    rng = np.random.default_rng(seed)
    fi = rng.choice(len(faces), size=n_samples, p=area / total)
    u = rng.random(n_samples)
    v = rng.random(n_samples)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (tri[fi, 0] + u[:, None] * v1[fi] + v[:, None] * v2[fi])


# -------------------------------------------------------------- downsample

def radius_downsample(points: np.ndarray, radius: float,
                      seed: Optional[int] = None) -> np.ndarray:
    """Greedy radius-NN thinning after a random shuffle (eval.py:81-96),
    by the native grid-hash kernel (its plain version is the KD-tree loop,
    native.greedy_radius_downsample_mask_plain)."""
    from gs2mesh_torch import native

    pts = points.copy()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    return pts[native.greedy_radius_downsample_mask(pts, radius)]


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Open3D-style voxel grid downsample (centroid per occupied voxel)."""
    if len(points) == 0:
        return points
    lo = points.min(axis=0)
    keys = np.floor((points - lo) / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


# --------------------------------------------------------------- distances

def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each src point, the distance to its nearest dst point."""
    if len(dst) == 0:
        return np.full(len(src), np.inf)
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, workers=-1)
    return d


# --------------------------------------------------------------- alignment

def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scaling: bool = True) -> np.ndarray:
    """Closed-form similarity transform aligning src -> dst (Umeyama 1991).

    Replaces the reference's RANSAC-on-known-correspondences
    (registration.py:65-104) — with exact 1:1 correspondences and zero
    jitter the RANSAC consensus converges to this estimate."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scaling:
        var_s = (xs ** 2).sum() / len(src)
        scale = np.trace(np.diag(D) @ S) / var_s
    else:
        scale = 1.0
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = mu_d - scale * R @ mu_s
    return T


def _rigid_from_correspondences(src, dst):
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       max_corr_dist: float, init: Optional[np.ndarray] = None,
                       max_iteration: int = 20) -> Tuple[np.ndarray, float, float]:
    """Point-to-point ICP (Open3D registration_icp semantics: NN
    correspondences within `max_corr_dist`, SVD rigid update).

    Returns (transformation (4,4), fitness, inlier_rmse)."""
    T = np.eye(4) if init is None else init.copy()
    tree = cKDTree(dst)
    fitness, rmse = 0.0, 0.0
    for _ in range(max_iteration):
        cur = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(cur, k=1, distance_upper_bound=max_corr_dist,
                            workers=-1)
        inlier = np.isfinite(d)
        fitness = inlier.mean() if len(d) else 0.0
        if inlier.sum() < 3:
            break
        rmse = float(np.sqrt((d[inlier] ** 2).mean()))
        step = _rigid_from_correspondences(cur[inlier], dst[idx[inlier]])
        T = step @ T
        if np.allclose(step, np.eye(4), atol=1e-9):
            break
    return T, float(fitness), float(rmse)
