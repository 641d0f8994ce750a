"""Isosurface extraction: marching tetrahedra over the TSDF, on the device.

Port of gs2mesh_tpu fusion/marching.py (the reference's Open3D
``volume.extract_triangle_mesh()``, tsdf_utils.py:108): the Kuhn
6-tetrahedra decomposition of each cell with case tables generated at import
by the JAX package's construction (winding fixed against unit-cube geometry
so every triangle's normal points toward positive TSDF). Vertices land on
cell edges at the linear zero crossing and are deduplicated by edge key
(the lower grid point and the step to the other), so shared edges give
shared vertices.

The JAX package runs this on the host in numpy; here it is tensor code on
the volume's device (``nonzero``, ``unique(sorted=True,
return_inverse=True)``, gathers), with the same cell, face and vertex order,
and returns a ``Mesh`` of host numpy arrays. Vertex positions are
interpolated in float64 and rounded once, as numpy's int64 promotion does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Cube corner k at offset (k & 1, (k >> 1) & 1, (k >> 2) & 1).
_CORNER_OFF = np.array([[(k & 1), (k >> 1) & 1, (k >> 2) & 1]
                        for k in range(8)], np.int64)

# Kuhn triangulation: 6 tets sharing the main diagonal c0-c7, one per
# axis-order path from corner 0 to corner 7.
_TETS = []
for path in [(1, 3), (1, 5), (2, 3), (2, 6), (4, 5), (4, 6)]:
    _TETS.append((0, path[0], path[1], 7))

_MAX_TRIS = 12  # ≤ 2 triangles per tet × 6 tets

# Above this many cells, the block extractor's slot grid over the bounding
# box of the blocks (int32, 4 bytes a cell: 2^24 cells = 64 MiB) gives way to
# a searchsorted lookup over the sorted blocks. A surface shell's box holds
# ~10^4-10^5 cells (DTU scale: ~32^3); an outlier block far from the rest
# makes it cubic in the distance, several GB at the packing range's
# 1024^3 (the reference's ADVICE.md:4).
SLOT_GRID_LIMIT = 1 << 24


def _tet_case_triangles(tet, inside):
    """Triangles for one tet given the inside flags of its 4 corners.

    Returns a list of triangles; each triangle is 3 edges; each edge is a
    (cube-corner-inside, cube-corner-outside) pair.
    """
    ins = [tet[i] for i in range(4) if inside[i]]
    outs = [tet[i] for i in range(4) if not inside[i]]
    if len(ins) == 0 or len(outs) == 0:
        return []
    if len(ins) == 1:
        v = ins[0]
        return [[(v, outs[0]), (v, outs[1]), (v, outs[2])]]
    if len(ins) == 3:
        v = outs[0]
        return [[(ins[0], v), (ins[1], v), (ins[2], v)]]
    # 2 in / 2 out: quad across four crossing edges, split into 2 triangles.
    i1, i2 = ins
    o1, o2 = outs
    e11, e12, e21, e22 = (i1, o1), (i1, o2), (i2, o1), (i2, o2)
    return [[e11, e12, e22], [e11, e22, e21]]


def _orient(tri, corner_pos, inside_mask):
    """Fix winding so the normal points toward the outside (positive TSDF),
    evaluated with midpoint vertices on concrete unit-cube geometry."""
    pts = [0.5 * (corner_pos[a] + corner_pos[b]) for a, b in tri]
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    ins = [corner_pos[k] for k in range(8) if (inside_mask >> k) & 1]
    out = [corner_pos[k] for k in range(8) if not (inside_mask >> k) & 1]
    d = np.mean(out, axis=0) - np.mean(ins, axis=0)
    if np.dot(n, d) < 0:
        return [tri[0], tri[2], tri[1]]
    return tri


def _build_tables():
    """(256, 12, 3, 2) edge-corner table + (256,) triangle counts."""
    table = np.full((256, _MAX_TRIS, 3, 2), -1, np.int8)
    counts = np.zeros((256,), np.int8)
    pos = _CORNER_OFF.astype(np.float64)
    for mask in range(1, 255):
        tris = []
        for tet in _TETS:
            inside = [(mask >> tet[i]) & 1 for i in range(4)]
            tris += _tet_case_triangles(tet, inside)
        tris = [_orient(t, pos, mask) for t in tris]
        counts[mask] = len(tris)
        for ti, t in enumerate(tris):
            for vi, (a, b) in enumerate(t):
                table[mask, ti, vi, 0] = a
                table[mask, ti, vi, 1] = b
    return table, counts


_TABLE, _COUNTS = _build_tables()


class Mesh(NamedTuple):
    vertices: np.ndarray            # (V, 3) f32 world coordinates
    faces: np.ndarray               # (F, 3) int32
    vertex_colors: Optional[np.ndarray] = None   # (V, 3) f32 in [0, 1]
    vertex_normals: Optional[np.ndarray] = None  # (V, 3) f32


def grid_origin(origin, lo, bs: int, voxel_size: float) -> np.ndarray:
    """World position of grid point 0 of a grid whose first block is ``lo``,
    in the JAX package's float32 arithmetic."""
    return np.asarray(origin, np.float32) + \
        np.asarray(lo).astype(np.float32) * bs * voxel_size


def _empty_mesh() -> Mesh:
    return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))


def _cells(inside: torch.Tensor, observed: torch.Tensor, span):
    """Active cells (all 8 corners observed, the surface inside) of a grid
    or of a batch of blocks, over the leading ``span`` cells of the last
    three axes (corner k at _CORNER_OFF[k]): their indices in nonzero order
    and their case masks."""
    mask = cvalid = None
    for k, (dx, dy, dz) in enumerate(_CORNER_OFF.tolist()):
        sl = (Ellipsis, slice(dx, dx + span[0]), slice(dy, dy + span[1]),
              slice(dz, dz + span[2]))
        bit = inside[sl].to(torch.int32) << k
        mask = bit if mask is None else mask | bit
        cvalid = observed[sl] if cvalid is None else cvalid & observed[sl]
    active = cvalid & (mask != 0) & (mask != 255)
    return torch.nonzero(active), mask[active]


def marching_tetrahedra(tsdf, weight, color, origin, voxel_size: float,
                        iso: float = 0.0) -> Mesh:
    """Extract the ``tsdf == iso`` surface from a dense grid (tensors, or
    arrays taken as CPU tensors).

    Grid point (i, j, k) sits at world ``origin + (idx + 0.5) * voxel_size``
    (voxel centers, matching tsdf.integrate). Cells whose 8 corners are not
    all observed (weight > 0) are skipped, as Open3D does.
    """
    tsdf = torch.as_tensor(tsdf)
    weight = torch.as_tensor(weight, device=tsdf.device)
    X, Y, Z = tsdf.shape
    if min(X, Y, Z) < 2:
        return _empty_mesh()
    sd = tsdf - iso
    cells, m = _cells(sd < 0, weight > 0, (X - 1, Y - 1, Z - 1))
    if cells.shape[0] == 0:
        return _empty_mesh()
    color_flat = None if color is None else \
        torch.as_tensor(color, device=tsdf.device).reshape(-1, 3)

    def index_of(p):
        return (p[:, 0] * Y + p[:, 1]) * Z + p[:, 2]

    return _emit_mesh(m, cells, index_of, sd.reshape(-1), color_flat,
                      (X, Y, Z), np.asarray(origin, np.float32), voxel_size)


def _emit_mesh(m, active_cells, index_of, sd_flat, color_flat, vdims, origin,
               voxel_size) -> Mesh:
    """Shared marching tail: case-table lookup over active cells -> mesh.

    m: (M,) case masks; active_cells: (M, 3) int64 grid coords of the cells
    (relative to ``origin``); index_of maps (K, 3) grid-point coords to
    indices into sd_flat / color_flat; vdims: virtual grid-point dims for
    edge-key packing."""
    dev = active_cells.device
    X, Y, Z = (int(v) for v in vdims)
    table = torch.from_numpy(_TABLE).to(dev)
    counts = torch.from_numpy(_COUNTS).to(dev)
    corner_off = torch.from_numpy(_CORNER_OFF).to(dev)
    m = m.long()
    ntri = counts[m].long()                                   # (M,)
    tvalid = torch.arange(_MAX_TRIS, device=dev)[None, :] < ntri[:, None]

    # Compact to the valid triangles first (avg ~2.5 of the 12 table slots).
    tidx = torch.nonzero(tvalid.reshape(-1))[:, 0]            # (F,)
    tris_v = table[m].reshape(-1, 3, 2)[tidx].long()          # (F, 3, 2)
    cells_v = active_cells[tidx // _MAX_TRIS]                 # (F, 3)
    pa = cells_v[:, None, :] + corner_off[tris_v[..., 0]]     # grid coords
    pb = cells_v[:, None, :] + corner_off[tris_v[..., 1]]

    def gid(p):
        return (p[..., 0] * Y + p[..., 1]) * Z + p[..., 2]

    # An edge joins corners whose offsets differ by a step in {0,1}^3, so it
    # is keyed by its lower grid point and that step (JAX packs
    # lo * X*Y*Z + hi, which sorts the same way but overflows int64 past
    # ~1400 grid points a side, as an outlier block makes it).
    ga, gb = gid(pa), gid(pb)
    swap = (gb < ga)[..., None]
    low = torch.where(swap, pb, pa)
    step = torch.where(swap, pa, pb) - low                    # (F, 3, 3)
    ekey = gid(low) * 8 + (step[..., 0] * 4 + step[..., 1] * 2
                           + step[..., 2])
    uniq, inv = torch.unique(ekey.reshape(-1), sorted=True,
                             return_inverse=True)
    faces = inv.reshape(-1, 3).to(torch.int32)

    g = uniq // 8
    A = torch.stack([g // (Y * Z), (g // Z) % Y, g % Z], dim=-1)
    code = uniq % 8
    B = A + torch.stack([code >> 2, (code >> 1) & 1, code & 1], dim=-1)
    ia, ib = index_of(A), index_of(B)
    sa, sb = sd_flat[ia], sd_flat[ib]
    diff = sa - sb
    t = sa / torch.where(diff.abs() < 1e-30,
                         torch.full_like(diff, 1e-30), diff)
    t = torch.clamp(t, 0.0, 1.0)[:, None]
    verts = (A.double() + 0.5) + t.double() * (B - A).double()
    verts = (verts * voxel_size
             + torch.from_numpy(np.asarray(origin, np.float32)).to(dev)
             .double()).float()

    vcolors = None
    if color_flat is not None:
        colA, colB = color_flat[ia], color_flat[ib]
        vcolors = (colA + t * (colB - colA)).cpu().numpy()

    normals = vertex_normals(verts, faces)
    return Mesh(verts.cpu().numpy(), faces.cpu().numpy(), vcolors,
                normals.cpu().numpy())


def _block_lookup(coords: torch.Tensor, lo: torch.Tensor, dims):
    """slot_of(c) -> (slot, hit) for (…, 3) block coords: a dense slot grid
    over the blocks' bounding box, or past SLOT_GRID_LIMIT cells a
    searchsorted over the blocks' sorted linear box indices."""
    dev = coords.device
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)

    def linear(r):
        return (r[..., 0] * dims[1] + r[..., 1]) * dims[2] + r[..., 2]

    n = coords.shape[0]
    slots = torch.arange(n, dtype=torch.int64, device=dev)
    cells = dims[0] * dims[1] * dims[2]
    if cells <= SLOT_GRID_LIMIT:
        grid = torch.full((cells,), -1, dtype=torch.int32, device=dev)
        grid[linear(coords - lo)] = slots.to(torch.int32)

        def find(lin):
            slot = grid[lin].long()
            return slot, slot >= 0
    else:
        keys, perm = torch.sort(linear(coords - lo))

        def find(lin):
            pos = torch.searchsorted(keys, lin).clamp(max=n - 1)
            return perm[pos], keys[pos] == lin

    def slot_of(c):
        r = c - lo
        inb = ((r >= 0) & (r < dims_t)).all(dim=-1)
        slot, hit = find(torch.where(inb, linear(r),
                                     torch.zeros_like(r[..., 0])))
        hit = inb & hit
        return torch.where(hit, slot, torch.full_like(slot, -1)), hit

    return slot_of


def marching_tetrahedra_blocks(coords, tsdf, weight, color, origin,
                               voxel_size: float, bs: int,
                               iso: float = 0.0) -> Mesh:
    """Block-sparse marching tetrahedra: the same mesh as dense-ifying the
    blocks and calling ``marching_tetrahedra``, without the bounding-box
    grid.

    coords: (n, 3) int block coords; tsdf/weight: (n, bs, bs, bs); color:
    (n, bs, bs, bs, 3) or None; tensors on one device. Grid point
    (block * bs + local) sits at world ``origin + (idx + 0.5) * voxel_size``,
    matching to_dense.
    """
    n = coords.shape[0]
    if n == 0:
        return _empty_mesh()
    dev = tsdf.device
    coords = coords.long()
    lo = coords.min(dim=0).values
    hi = coords.max(dim=0).values + 1
    lo_np = lo.cpu().numpy()
    dims = (hi - lo).tolist()
    slot_of = _block_lookup(coords, lo, dims)

    sd = tsdf.float() - iso
    # Corner-extended per-block stacks (n, bs+1, bs+1, bs+1): own voxels
    # plus the +x/+y/+z faces, edges and corner stitched from the 7 forward
    # neighbors (absent neighbor => weight 0 => those cells are skipped,
    # exactly like the dense grid's unobserved padding).
    e = bs + 1
    sd_e = sd.new_zeros((n, e, e, e))
    w_e = weight.new_zeros((n, e, e, e))
    sd_e[:, :bs, :bs, :bs] = sd
    w_e[:, :bs, :bs, :bs] = weight
    for off in ((0, 0, 1), (0, 1, 0), (1, 0, 0), (0, 1, 1),
                (1, 0, 1), (1, 1, 0), (1, 1, 1)):
        nb, hit = slot_of(coords + torch.tensor(off, device=dev))
        bidx = torch.nonzero(hit)[:, 0]
        src = nb[bidx]
        dst = tuple(slice(bs, e) if o else slice(0, bs) for o in off)
        srs = tuple(slice(0, 1) if o else slice(0, bs) for o in off)
        sd_e[(bidx,) + dst] = sd[(src,) + srs]
        w_e[(bidx,) + dst] = weight[(src,) + srs]

    found, m = _cells(sd_e < 0, w_e > 0, (bs, bs, bs))
    if found.shape[0] == 0:
        return _empty_mesh()
    cells = (coords[found[:, 0]] - lo) * bs + found[:, 1:]

    def index_of(p):
        """Flat voxel index of global grid points (relative to lo*bs)."""
        slot, hit = slot_of(p // bs + lo)
        if not bool(hit.all()):
            raise RuntimeError("queried grid point outside allocated blocks")
        loc = p % bs
        return ((slot * bs + loc[:, 0]) * bs + loc[:, 1]) * bs + loc[:, 2]

    vdims = [d * bs + 1 for d in dims]
    color_flat = None if color is None else color.reshape(-1, 3)
    return _emit_mesh(m, cells, index_of, sd.reshape(-1), color_flat, vdims,
                      grid_origin(origin, lo_np, bs, voxel_size), voxel_size)


def vertex_normals(vertices: torch.Tensor,
                   faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (Open3D compute_vertex_normals
    equivalent, tsdf_utils.py:110), on the tensors' device. The face
    normals are added per corner in face order (``np.add.at``'s order on the
    CPU; on CUDA the atomics' order, so normals agree there to rounding)."""
    if faces.numel() == 0:
        return torch.zeros_like(vertices)
    f = faces.long()
    v0 = vertices[f[:, 0]]
    a = vertices[f[:, 1]] - v0
    b = vertices[f[:, 2]] - v0
    # np.cross's arithmetic: each product rounded, then the difference.
    fn = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                      a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                      a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    n = torch.zeros_like(vertices)
    for k in range(3):
        n.index_add_(0, f[:, k], fn)
    norm = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                      + n[:, 2] * n[:, 2])[:, None]
    return n / torch.where(norm < 1e-20, torch.ones_like(norm), norm)
