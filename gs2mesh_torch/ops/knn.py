"""Mean squared distance to the 3 nearest neighbours (gaussian scale init).

Port of gs2mesh_tpu ops/knn.py, the stand-in for the reference's simple-knn
CUDA extension (simple_knn.cu:185-221): Morton-code sort + windowed
candidate search under several fixed rotations of the cloud, candidates
deduplicated by neighbour index before the min-k reduction. Plain tensor
ops (sorts and gathers) on the points' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 16     # Morton-order neighbours on each side of a point
N_PASSES = 6    # rotations of the cloud whose Morton orders are merged


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) float points -> (N,) int32 30-bit Morton codes over their
    bounding box."""
    lo = points.min(dim=0, keepdim=True).values
    hi = points.max(dim=0, keepdim=True).values
    uvw = (points - lo) / torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp(uvw * 1023.0, 0, 1023).to(torch.int32)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))


def _window_candidates(points, codes):
    """Candidate (squared distance, neighbour index) pairs in input order."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(codes, stable=True)
    sorted_pts = points[order]
    offs = torch.cat([torch.arange(-WINDOW, 0, device=dev),
                      torch.arange(1, WINDOW + 1, device=dev)])
    ar = torch.arange(n, device=dev)
    idx = torch.clamp(ar[:, None] + offs[None, :], 0, n - 1)
    cand = sorted_pts[idx]                                  # (N, 2W, 3)
    d2 = torch.sum((cand - sorted_pts[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(idx == ar[:, None], torch.inf, d2)
    nbr = order[idx]                                        # input-order ids
    inv = torch.empty_like(order)
    inv[order] = ar
    return d2[inv], nbr[inv]                                # (N, 2W) each


@functools.lru_cache(maxsize=None)
def _pass_rotations(n_passes: int):
    """Fixed pseudo-random orthonormal matrices decorrelating the Morton
    boundary planes between passes (pass 0 is the identity)."""
    rng = np.random.default_rng(0x5EED)
    mats = [np.eye(3, dtype=np.float32)]
    for _ in range(n_passes - 1):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append(q.astype(np.float32))
    return mats


def mean_sq_dist_knn(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest distinct
    neighbours among the windowed Morton-order candidates."""
    passes = [
        _window_candidates(
            points, morton_codes(points @ torch.from_numpy(R.T).to(
                points.device)))
        for R in _pass_rotations(N_PASSES)]
    d2 = torch.cat([p[0] for p in passes], dim=1)           # (N, 2W * passes)
    nbr = torch.cat([p[1] for p in passes], dim=1)
    # Narrow to the m smallest, then drop repeated neighbour ids (window
    # clipping at the sort-order edges can repeat one neighbour up to
    # 2 * WINDOW times).
    m = 2 * WINDOW + 4 * k
    dtop, pos = torch.topk(d2, m, dim=1, largest=False, sorted=True)
    itop = torch.gather(nbr, 1, pos)
    ar = torch.arange(m, device=points.device)
    dup = (itop[:, :, None] == itop[:, None, :]) & (ar[:, None] > ar[None, :])
    dtop = torch.where(dup.any(dim=2), torch.inf, dtop)
    top = torch.topk(dtop, k, dim=1, largest=False, sorted=True).values
    return torch.mean(top, dim=1)


def mean_sq_dist_3nn(points: torch.Tensor) -> torch.Tensor:
    """distCUDA2 equivalent (simple_knn.cu:185)."""
    return mean_sq_dist_knn(points, k=3)


def mean_sq_dist_3nn_exact(points: torch.Tensor) -> torch.Tensor:
    """O(N^2) exact version for tests and small N."""
    d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    n = points.shape[0]
    d2 = torch.where(torch.eye(n, dtype=torch.bool, device=points.device),
                     torch.inf, d2)
    return torch.mean(torch.topk(d2, 3, dim=1, largest=False).values, dim=1)
