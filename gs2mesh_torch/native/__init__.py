"""Native (C++) host kernels of the evaluations and mesh post-processing.

The port's copy of gs2mesh_tpu native/: greedy radius downsampling (the
DTUeval thinning), triangle connected-component clustering and grid-bounded
NN distances, from ``src/geom_ops.cpp`` through a plain C interface and
ctypes. The library is built with g++ on first use into ``build/`` (keyed
by a hash of the source and the flags, so a changed source is rebuilt), and
a failed build raises: unlike the JAX package, no entry point falls back to
Python on its own. The Python versions beside them (``*_plain``) are their
plain versions, which the tests hold them to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "geom_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# The JAX package's flags, so both builds round alike on one host (with
# -march=native the compiler may contract the distances into FMAs). The
# build directory is git-ignored: a checkout never carries another host's
# library.
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"_geom_ops-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC.name} needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _target()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_f64p = ctypes.POINTER(ctypes.c_double)
        lib.greedy_radius_downsample.argtypes = [
            c_f32p, ctypes.c_int64, ctypes.c_float, c_u8p]
        lib.greedy_radius_downsample.restype = None
        lib.triangle_clusters.argtypes = [
            c_i32p, ctypes.c_int64, ctypes.c_int64, c_i64p, c_i64p]
        lib.triangle_clusters.restype = ctypes.c_int64
        lib.nn_sq_distances_grid.argtypes = [
            c_f32p, ctypes.c_int64, c_f32p, ctypes.c_int64, ctypes.c_float,
            c_f64p]
        lib.nn_sq_distances_grid.restype = None
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _points(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {pts.shape}")
    return pts


def greedy_radius_downsample_mask(points: np.ndarray,
                                  radius: float) -> np.ndarray:
    """(N, 3) points (in desired greedy order) -> keep mask: each point
    not yet suppressed is kept and suppresses every point within
    ``radius`` of it (float32 coordinates, float64 distances)."""
    lib = get_lib()
    pts = _points(points)
    mask = np.empty(len(pts), np.uint8)
    lib.greedy_radius_downsample(_ptr(pts, ctypes.c_float), len(pts),
                                 ctypes.c_float(radius),
                                 _ptr(mask, ctypes.c_uint8))
    return mask.astype(bool)


def triangle_clusters(faces: np.ndarray, num_vertices: int):
    """Union-find clustering of triangles sharing a vertex. Returns
    (labels (F,), counts (n_clusters,)), clusters numbered by first
    appearance in face order."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, np.int32)
    if f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"expected (F, 3) faces, got {f.shape}")
    if len(f) and (f.min() < 0 or f.max() >= num_vertices):
        raise ValueError("face index out of range")
    labels = np.zeros(len(f), np.int64)
    counts = np.zeros(max(len(f), 1), np.int64)
    n = lib.triangle_clusters(_ptr(f, ctypes.c_int32), len(f),
                              num_vertices, _ptr(labels, ctypes.c_int64),
                              _ptr(counts, ctypes.c_int64))
    return labels, counts[:n]


def nn_sq_distances_grid(ref: np.ndarray, query: np.ndarray,
                         radius: float) -> np.ndarray:
    """For each query point, the squared distance to its nearest ``ref``
    point within ``radius``; inf where there is none."""
    lib = get_lib()
    r = _points(ref)
    q = _points(query)
    out = np.empty(len(q), np.float64)
    lib.nn_sq_distances_grid(_ptr(r, ctypes.c_float), len(r),
                             _ptr(q, ctypes.c_float), len(q),
                             ctypes.c_float(radius),
                             _ptr(out, ctypes.c_double))
    return out


# ------------------------------------------------------------ plain versions

def greedy_radius_downsample_mask_plain(points: np.ndarray,
                                        radius: float) -> np.ndarray:
    """The KD-tree loop of the JAX package's fallback (DTUeval eval.py:
    86-96) on the native kernel's float32 coordinates and radius."""
    from scipy.spatial import cKDTree

    pts = _points(points).astype(np.float64)
    tree = cKDTree(pts)
    mask = np.ones(len(pts), dtype=bool)
    for curr, idxs in enumerate(tree.query_ball_point(
            pts, r=float(np.float32(radius)))):
        if mask[curr]:
            mask[idxs] = False
            mask[curr] = True
    return mask


def triangle_clusters_plain(faces: np.ndarray, num_vertices: int):
    """scipy's connected components, numbered by first appearance."""
    from gs2mesh_torch.fusion.mesh import cluster_connected_triangles

    return cluster_connected_triangles(np.asarray(faces), num_vertices)


def nn_sq_distances_grid_plain(ref: np.ndarray, query: np.ndarray,
                               radius: float) -> np.ndarray:
    from scipy.spatial import cKDTree

    d, _ = cKDTree(_points(ref).astype(np.float64)).query(
        _points(query).astype(np.float64), k=1,
        distance_upper_bound=float(np.float32(radius)))
    return np.where(np.isfinite(d), d ** 2, np.inf)
