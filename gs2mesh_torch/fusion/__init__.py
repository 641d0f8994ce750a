"""TSDF fusion + isosurface extraction + mesh cleaning (replaces Open3D).

Port of gs2mesh_tpu fusion/ (the reference TSDF stage,
tsdf_utils.py:23-182): integrate per-view RGB-D into a block-sparse TSDF
volume on the device, extract a triangle mesh on the device, clean small
clusters and write PLY on the host. Plain PyTorch: the JAX package has no
Pallas kernel here (integration is XLA, extraction host numpy).
"""

from gs2mesh_torch.fusion.tsdf import (EMPTY_KEY, TSDFConfig, TSDFVolume,
                                       allocate, create_volume, grow_volume,
                                       integrate, integrate_view, to_dense,
                                       unpack_keys, unpack_keys_tensor)
from gs2mesh_torch.fusion.marching import (Mesh, marching_tetrahedra,
                                           marching_tetrahedra_blocks,
                                           vertex_normals)
from gs2mesh_torch.fusion.mesh import (clean_mesh,
                                       cluster_connected_triangles,
                                       mesh_edges,
                                       remove_unreferenced_vertices,
                                       scale_mesh, write_mesh)


def extract_triangle_mesh(vol: TSDFVolume, cfg: TSDFConfig,
                          dense: bool = False) -> Mesh:
    """Extract the zero-isosurface mesh from the sparse volume
    (volume.extract_triangle_mesh equivalent, tsdf_utils.py:108), on the
    volume's device.

    Default path is block-sparse marching tetrahedra over the live blocks
    only — the same mesh as dense-ifying the bounding box, without the corner
    stacks over its (mostly empty) interior. ``dense=True`` keeps the
    bounding-box path (tiny volumes, equivalence tests)."""
    if dense:
        tsdf, weight, color, origin = to_dense(vol, cfg)
        return marching_tetrahedra(tsdf, weight, color, origin,
                                   cfg.voxel_size)
    bs = cfg.block_size
    n = vol.n_blocks
    coords = unpack_keys_tensor(vol.keys[:n])
    return marching_tetrahedra_blocks(
        coords, vol.tsdf[:n].reshape(n, bs, bs, bs),
        vol.weight[:n].reshape(n, bs, bs, bs),
        vol.color[:n].reshape(n, bs, bs, bs, 3),
        cfg.origin, cfg.voxel_size, bs)


__all__ = [
    "TSDFConfig", "TSDFVolume", "create_volume", "integrate", "allocate",
    "integrate_view", "to_dense", "Mesh", "marching_tetrahedra",
    "marching_tetrahedra_blocks", "vertex_normals", "clean_mesh",
    "cluster_connected_triangles", "remove_unreferenced_vertices",
    "scale_mesh", "mesh_edges", "write_mesh", "extract_triangle_mesh",
]
