"""Mesh post-processing on the host: connected-triangle clustering, cleaning,
scaling and the PLY writer.

Port of gs2mesh_tpu fusion/mesh.py (the reference's Open3D
``cluster_connected_triangles`` + small-cluster removal,
tsdf_utils.py:122-142): triangles sharing a vertex are in one cluster;
clusters with fewer than ``min_triangles`` faces are dropped, then
unreferenced vertices are compacted away.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from gs2mesh_torch.core.ply import write_mesh_ply
from gs2mesh_torch.fusion.marching import Mesh, vertex_normals


def cluster_connected_triangles(faces: np.ndarray, num_vertices: int):
    """Label triangles by vertex-connected component.

    Returns (triangle_clusters (F,), cluster_n_triangles (n_clusters,)) —
    the contract of Open3D's cluster_connected_triangles
    (tsdf_utils.py:128-131) — with clusters numbered in order of first
    appearance in face order, as the JAX package's native union-find
    numbers them (its geom_ops.cpp::triangle_clusters).
    """
    F = faces.shape[0]
    if F == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    # Vertex graph: two edges of every triangle join its three vertices.
    rows = np.concatenate([faces[:, 0], faces[:, 0]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    g = sp.coo_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                      shape=(num_vertices, num_vertices))
    _, vlabel = csgraph.connected_components(g, directed=False)
    comp, first, inverse = np.unique(vlabel[faces[:, 0]], return_index=True,
                                     return_inverse=True)
    rank = np.empty(comp.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(comp.size)
    tclusters = rank[inverse]
    return tclusters, np.bincount(tclusters, minlength=comp.size).astype(
        np.int64)


def remove_unreferenced_vertices(mesh: Mesh) -> Mesh:
    used = np.zeros(mesh.vertices.shape[0], bool)
    used[mesh.faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return Mesh(
        vertices=mesh.vertices[used],
        faces=remap[mesh.faces].astype(np.int32),
        vertex_colors=None if mesh.vertex_colors is None
        else mesh.vertex_colors[used],
        vertex_normals=None if mesh.vertex_normals is None
        else mesh.vertex_normals[used],
    )


def clean_mesh(mesh: Mesh, min_triangles: int = 10000) -> Mesh:
    """Drop connected clusters with < ``min_triangles`` faces
    (tsdf_utils.py:122-142 default thres=10000)."""
    tclusters, counts = cluster_connected_triangles(
        mesh.faces, mesh.vertices.shape[0])
    if counts.size == 0:
        return mesh
    keep = counts[tclusters] >= min_triangles
    return remove_unreferenced_vertices(mesh._replace(faces=mesh.faces[keep]))


def scale_mesh(mesh: Mesh, scale: float) -> Mesh:
    """Rescale vertices (undo the 1/TSDF_scale extrinsic scaling,
    tsdf_utils.py:109)."""
    return mesh._replace(vertices=mesh.vertices * np.float32(scale))


def recompute_normals(mesh: Mesh) -> Mesh:
    return mesh._replace(vertex_normals=vertex_normals(
        torch.from_numpy(mesh.vertices),
        torch.from_numpy(mesh.faces)).numpy())


def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """(E, 2) undirected unique edges."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def write_mesh(path: str, mesh: Mesh) -> None:
    colors = mesh.vertex_colors
    if colors is not None:
        colors = np.clip(colors, 0.0, 1.0)
    write_mesh_ply(path, mesh.vertices, mesh.faces, colors=colors,
                   normals=mesh.vertex_normals)
