"""The port's TSDF fusion, marching tetrahedra and mesh cleaning
(gs2mesh_torch.fusion) against the JAX package's (gs2mesh_tpu.fusion), on
the CPU.

The scene is tests/test_fusion.py's: analytic depth maps of the unit sphere
from 20 views at 128x128, fused into a block-sparse volume (voxel 0.02,
trunc 0.06, capacity 4096, stride 2). JAX runs eagerly, as test_fusion.py
runs it; the port follows its arithmetic op by op, so the volume must match
after every view: keys, order, n_blocks, overflow and weight equal, tsdf and
colour within 1e-6 apart from voxels whose pixel lookup flipped (counted,
<= 1e-4 of the live voxels). Extraction is held to JAX on JAX's own volume
(faces, vertices and colours bit for bit, normals within 1e-6), then the
seven tests of test_fusion.py are repeated on the port's volume.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu import fusion as J
from gs2mesh_tpu.core.ply import read_ply as j_read_ply
from gs2mesh_tpu.fusion import mesh as j_mesh
from gs2mesh_tpu.fusion import tsdf as j_tsdf
from gs2mesh_torch import fusion as P
from gs2mesh_torch.core.ply import read_ply
from gs2mesh_torch.fusion import marching as p_marching
from gs2mesh_torch.fusion import mesh as p_mesh
from gs2mesh_torch.fusion import tsdf as p_tsdf
from gs2mesh_torch.fusion.convert import (FIELDS, volume_from_numpy,
                                          volume_to_numpy)
from tests.test_fusion import (_face_soup, look_at_extrinsic, make_K,
                               sphere_depth)

torch.set_num_threads(1)

W = H = 128
N_VIEWS = 20
JCFG = J.TSDFConfig(voxel_size=0.02, sdf_trunc=0.06, block_size=8,
                    block_capacity=4096, alloc_stride=2)
PCFG = P.TSDFConfig(*JCFG)


def sphere_views():
    """test_fusion.py's fused_sphere views: (color, depth, K, extrinsic)."""
    K = make_K(W, H)
    rng = np.random.default_rng(0)
    for i in range(N_VIEWS):
        th = 2 * np.pi * i / N_VIEWS
        z = 0.8 * np.sin(3 * th + rng.uniform(0, 0.2))
        E = look_at_extrinsic(np.array([2.6 * np.cos(th), 2.6 * np.sin(th),
                                        z]))
        depth = sphere_depth(K, E, W, H)
        color = np.zeros((H, W, 3), np.float32)
        color[..., 0] = np.clip(depth / 4.0, 0, 1)
        color[..., 1] = 0.5
        yield color, depth, K, E


def tensors(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def pixel_flips(vol, color, depth, K, E, cfg):
    """(n, V) mask of live voxels whose nearest-pixel lookup lies within
    1e-4 px of a rounding boundary (where a last-bit difference in the
    projection could move it)."""
    n = vol.n_blocks
    coords = p_tsdf.unpack_keys_tensor(vol.keys[:n]).double()
    pts = ((coords * cfg.block_size)[:, None, :]
           + p_tsdf._local_offsets(cfg.block_size, "cpu")[None].double()
           + 0.5) * cfg.voxel_size
    cam = pts @ torch.from_numpy(E[:3, :3]).double().T \
        + torch.from_numpy(E[:3, 3]).double()
    near = torch.zeros(cam.shape[:2], dtype=torch.bool)
    for ax, (f, c) in enumerate(((K[0, 0], K[0, 2]), (K[1, 1], K[1, 2]))):
        x = f * cam[..., ax] / cam[..., 2] + c
        near |= (x - torch.floor(x) - 0.5).abs() < 1e-4
    return near.numpy()


@pytest.fixture(scope="module")
def fused():
    """Both packages fuse the 20 views; after each view the port's volume is
    compared with JAX's. Returns (per-view records, JAX volume, port
    volume)."""
    jv = J.create_volume(JCFG)
    pv = P.create_volume(PCFG, "cpu")
    records = []
    for color, depth, K, E in sphere_views():
        jv = J.integrate_view(jv, color, depth, K, E, depth_trunc=4.0,
                              cfg=JCFG)
        pv = P.integrate_view(pv, *tensors(color, depth, K, E), 4.0, PCFG)
        j = {k: np.asarray(getattr(jv, k)) for k in FIELDS}
        p = volume_to_numpy(pv)
        n = int(j["n_blocks"])
        off = p["weight"][:n] != j["weight"][:n]
        for k, tol in (("tsdf", 1e-6), ("color", 1e-6)):
            gap = np.abs(p[k][:n] - j[k][:n])
            off |= (gap.reshape(n, -1, gap.shape[-1]).max(-1)
                    if k == "color" else gap) > tol
        records.append(dict(
            same={k: np.array_equal(p[k], j[k])
                  for k in ("keys", "order", "n_blocks", "overflow")},
            off=int(off.sum()),
            flips=int((off & pixel_flips(pv, color, depth, K, E,
                                         PCFG)).sum()),
            live=n * PCFG.block_size ** 3,
            gaps={k: float(np.abs(p[k][:n] - j[k][:n]).max())
                  for k in ("weight", "tsdf", "color")}))
    return records, jv, pv


def test_pack_unpack_keys_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-700, 700, size=(4000, 3)).astype(np.int32)
    coords[:10] = [[-512, -512, -512], [511, 511, 511], [512, 0, 0],
                   [0, -513, 0], [0, 0, 0], [-1, -1, -1], [511, -512, 0],
                   [0, 0, 512], [-600, 3, 4], [7, 8, 9]]
    keys = p_tsdf.pack_keys(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(keys,
                                  np.asarray(j_tsdf.pack_keys(coords)))
    assert (keys == P.EMPTY_KEY).sum() > 100
    np.testing.assert_array_equal(P.unpack_keys(keys), J.unpack_keys(keys))
    np.testing.assert_array_equal(
        p_tsdf.unpack_keys_tensor(torch.from_numpy(keys)).numpy(),
        np.asarray(j_tsdf.unpack_keys_jnp(jnp.asarray(keys))))
    inb = keys != P.EMPTY_KEY
    np.testing.assert_array_equal(P.unpack_keys(keys[inb]), coords[inb])


@pytest.mark.parametrize("voxel,trunc", [
    (0.02, 0.06),                 # tests/test_fusion.py's sphere
    (2.0 / 512, 0.04),            # DTU (TSDF_voxel 2), tools/bench_tsdf.py
    (16.0 / 512, 0.2),            # tests/test_pipeline.py's stage
    (0.04, 0.1),                  # test_fusion.py's grow test
    (1.0 / 512, 0.02),            # a finer volume (8 samples)
], ids=["test", "dtu", "stage", "grow", "fine"])
def test_sample_offsets_equal_jnp_linspace(voxel, trunc):
    cfg = P.TSDFConfig(voxel_size=voxel, sdf_trunc=trunc)
    bs_world = cfg.block_extent
    n = max(int(np.ceil(2.0 * trunc / bs_world)) + 1, 2) + 2
    ref = np.asarray(jnp.linspace(-trunc - bs_world, trunc + bs_world, n))
    got = p_tsdf.sample_offsets(cfg)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("view", range(N_VIEWS))
def test_volume_matches_jax_after_each_view(fused, view):
    records, _, _ = fused
    r = records[view]
    assert all(r["same"].values()), r
    # Voxels off the limits must be pixel-lookup flips, at most 1e-4 of the
    # live voxels; the port follows JAX's arithmetic, so none are expected.
    assert r["off"] == r["flips"] <= 1e-4 * r["live"], r
    assert r["off"] == 0, r


def test_fused_volume_has_no_overflow_and_grows(fused):
    records, jv, pv = fused
    n = [r["live"] for r in records]
    assert n == sorted(n) and n[0] < n[-1]
    assert not pv.overflow and 100 < pv.n_blocks < PCFG.block_capacity


@pytest.mark.parametrize("dense", [False, True], ids=["blocks", "dense"])
def test_extraction_of_jax_volume_matches_jax(fused, dense):
    """JAX's fused volume through convert into the port's extractor."""
    _, jv, _ = fused
    vol = volume_from_numpy({k: np.asarray(getattr(jv, k)) for k in FIELDS},
                            PCFG, "cpu")
    mp = P.extract_triangle_mesh(vol, PCFG, dense=dense)
    mj = J.extract_triangle_mesh(jv, JCFG, dense=dense)
    assert mp.faces.shape[0] > 2000
    assert mp.faces.dtype == np.int32 and mp.vertices.dtype == np.float32
    np.testing.assert_array_equal(mp.faces, mj.faces)
    np.testing.assert_array_equal(mp.vertices.view(np.int32),
                                  mj.vertices.view(np.int32))
    np.testing.assert_array_equal(mp.vertex_colors, mj.vertex_colors)
    np.testing.assert_allclose(mp.vertex_normals, mj.vertex_normals, rtol=0,
                               atol=1e-6)


def test_volume_roundtrip_through_numpy(fused):
    """The port's volume -> numpy -> JAX's extractor equals the port's own
    extraction; numpy -> port -> numpy is exact."""
    _, _, pv = fused
    arrays = volume_to_numpy(pv)
    back = volume_to_numpy(volume_from_numpy(arrays, PCFG, "cpu"))
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    jv = J.TSDFVolume(**{k: jnp.asarray(v) for k, v in arrays.items()})
    mj = J.extract_triangle_mesh(jv, JCFG)
    mp = P.extract_triangle_mesh(pv, PCFG)
    np.testing.assert_array_equal(mp.faces, mj.faces)
    np.testing.assert_array_equal(mp.vertices, mj.vertices)


# ---- the port twins of tests/test_fusion.py, on the port's volume

def test_tsdf_allocates_shell_only(fused):
    _, _, vol = fused
    n = vol.n_blocks
    assert not vol.overflow
    assert 100 < n < PCFG.block_capacity
    coords = P.unpack_keys(vol.keys[:n].numpy())
    assert (vol.keys[n:] == P.EMPTY_KEY).all()
    centers = (coords + 0.5) * PCFG.block_extent
    r = np.linalg.norm(centers, axis=1)
    assert np.all(np.abs(r - 1.0) < PCFG.block_extent * 2 + PCFG.sdf_trunc)


def test_fused_sphere_mesh_geometry(fused):
    _, _, vol = fused
    mesh = P.extract_triangle_mesh(vol, PCFG)
    assert mesh.vertices.shape[0] > 2000
    assert mesh.faces.shape[0] > 2000
    r = np.linalg.norm(mesh.vertices, axis=1)
    err = np.abs(r - 1.0)
    assert np.quantile(err, 0.98) < 2 * PCFG.voxel_size
    outward = (mesh.vertex_normals * mesh.vertices).sum(1) / np.maximum(r,
                                                                        1e-9)
    assert (outward > 0).mean() > 0.99
    e = np.sort(np.concatenate([mesh.faces[:, [0, 1]], mesh.faces[:, [1, 2]],
                                mesh.faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).mean() > 0.95
    v, f = mesh.vertices, mesh.faces
    signed = np.einsum("ij,ij->i", v[f[:, 0]],
                       np.cross(v[f[:, 1]], v[f[:, 2]])).sum() / 6.0
    assert abs(signed - 4.0 / 3.0 * np.pi) < 0.15 * 4.0 / 3.0 * np.pi
    assert np.all(np.abs(mesh.vertex_colors[:, 1] - 0.5) < 0.05)


def test_marching_tets_on_analytic_sdf():
    n = 48
    voxel = 2.4 / n
    idx = np.arange(n)
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    origin = np.array([-1.2, -1.2, -1.2], np.float32)
    world = (np.stack([gx, gy, gz], -1).astype(np.float32) + 0.5) * voxel \
        + origin
    sdf = np.linalg.norm(world, axis=-1) - 1.0
    weight = np.ones_like(sdf)
    mesh = P.marching_tetrahedra(sdf, weight, None, origin, voxel)
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert np.abs(r - 1.0).max() < 0.5 * voxel
    e = np.sort(np.concatenate([mesh.faces[:, [0, 1]], mesh.faces[:, [1, 2]],
                                mesh.faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert np.all(counts == 2)
    mj = J.marching_tetrahedra(sdf, weight, None, origin, voxel)
    np.testing.assert_array_equal(mesh.faces, mj.faces)
    np.testing.assert_array_equal(mesh.vertices, mj.vertices)


def block_straddles(mesh, cfg):
    blk = np.floor((mesh.vertices - np.asarray(cfg.origin))
                   / cfg.block_extent).astype(int)
    fb = blk[mesh.faces]
    return int((fb.max(axis=1) != fb.min(axis=1)).any(axis=1).sum())


def test_block_sparse_marching_matches_dense(fused):
    _, _, vol = fused
    mb = P.extract_triangle_mesh(vol, PCFG)
    md = P.extract_triangle_mesh(vol, PCFG, dense=True)
    assert mb.faces.shape == md.faces.shape
    assert mb.vertices.shape == md.vertices.shape
    assert _face_soup(mb) == _face_soup(md)

    def color_map(mesh):
        v = np.round(mesh.vertices, 5)
        return {tuple(p): tuple(np.round(c, 5))
                for p, c in zip(v, mesh.vertex_colors)}

    cmb, cmd = color_map(mb), color_map(md)
    assert cmb.keys() == cmd.keys()
    assert sum(1 for k in cmb if cmb[k] != cmd[k]) == 0
    assert block_straddles(mb, PCFG) > 100


def two_tetrahedra():
    tet_v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tet_f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    v = np.concatenate([tet_v, tet_v * 2 + 5.0])
    f = np.concatenate([np.repeat(tet_f, 2, axis=0), tet_f + 4])
    return P.Mesh(v, f.astype(np.int32), None, None), tet_v


def test_clean_mesh_drops_small_clusters():
    mesh, tet_v = two_tetrahedra()
    cleaned = P.clean_mesh(mesh, min_triangles=5)
    assert cleaned.faces.shape[0] == 8
    assert cleaned.vertices.shape[0] == 4
    assert np.allclose(cleaned.vertices, tet_v)


def test_mesh_roundtrip_ply(tmp_path, fused):
    _, _, vol = fused
    mesh = P.extract_triangle_mesh(vol, PCFG)
    p = str(tmp_path / "m.ply")
    P.write_mesh(p, mesh)
    d = read_ply(p)
    assert d.positions.shape == mesh.vertices.shape
    assert d.faces is not None and d.faces.shape == mesh.faces.shape
    np.testing.assert_array_equal(d.positions, mesh.vertices)
    np.testing.assert_array_equal(d.faces, mesh.faces)


def grow_views():
    """test_fusion.py's grow test: 6 views at 64x64."""
    K = make_K(64, 64, f=60.0)
    for i in range(6):
        th = 2 * np.pi * i / 6
        E = look_at_extrinsic(np.array([2.6 * np.cos(th), 2.6 * np.sin(th),
                                        0.4]))
        yield np.full((64, 64, 3), 0.25, np.float32), \
            sphere_depth(K, E, 64, 64), K, E


def fuse_port(cfg):
    """The stage's loop: allocate, grow and redo the allocation on
    overflow, integrate."""
    vol = P.create_volume(cfg, "cpu")
    grew = 0
    for color, depth, K, E in grow_views():
        c, d, k, e = tensors(color, depth, K, E)
        fresh = P.allocate(vol, d, k, e, 4.0, cfg)
        while fresh.overflow:
            vol, cfg = P.grow_volume(vol, cfg)
            grew += 1
            fresh = P.allocate(vol, d, k, e, 4.0, cfg)
        vol = P.integrate(fresh, c, d, k, e, 4.0, cfg)
    return vol, cfg, grew


def fuse_jax(cfg):
    """tests/test_fusion.py's grow loop on the JAX package (eager)."""
    vol = J.create_volume(cfg)
    for color, depth, K, E in grow_views():
        vol_prev = vol
        vol = J.integrate_view(vol, color, depth, K, E, depth_trunc=4.0,
                               cfg=cfg)
        while bool(vol.overflow):
            vol_prev, cfg = j_tsdf.grow_volume(vol_prev, cfg)
            vol = J.integrate_view(vol_prev, color, depth, K, E,
                                   depth_trunc=4.0, cfg=cfg)
    return vol, cfg


def test_grow_volume_no_silent_truncation():
    """Tiny capacity with grow-on-overflow against ample capacity (the
    port's own, by key) and against JAX's grown volume (slot for slot)."""
    base = P.TSDFConfig(voxel_size=0.04, sdf_trunc=0.1, block_size=8,
                        alloc_stride=2)
    small, cfg_small, grew = fuse_port(base._replace(block_capacity=64))
    big, _, grew_big = fuse_port(base._replace(block_capacity=2048))
    assert grew > 0 and grew_big == 0 and cfg_small.block_capacity > 64
    assert not small.overflow and small.n_blocks == big.n_blocks

    def by_key(vol):
        keys = vol.keys.numpy()
        live = keys != P.EMPTY_KEY
        idx = np.argsort(keys[live])
        return (keys[live][idx], vol.tsdf.numpy()[live][idx],
                vol.weight.numpy()[live][idx])

    for a, b in zip(by_key(small), by_key(big)):
        np.testing.assert_array_equal(a, b)

    jbase = J.TSDFConfig(*base._replace(block_capacity=64))
    jv, jcfg = fuse_jax(jbase)
    assert jcfg.block_capacity == cfg_small.block_capacity
    got = volume_to_numpy(small)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jv, k)),
                                      err_msg=k)


def test_allocate_leaves_its_input_volume_unchanged():
    cfg = P.TSDFConfig(voxel_size=0.04, sdf_trunc=0.1, alloc_stride=2,
                       block_capacity=256)
    color, depth, K, E = next(grow_views())
    vol = P.create_volume(cfg, "cpu")
    keys = vol.keys.clone()
    fresh = P.allocate(vol, *tensors(depth, K, E), 4.0, cfg)
    assert fresh.n_blocks > 0 and vol.n_blocks == 0
    assert torch.equal(vol.keys, keys)
    assert fresh.tsdf is vol.tsdf


# ---- the block lookup past SLOT_GRID_LIMIT

def with_outlier(vol, cfg, shift):
    """The port volume's blocks plus one outlier block ``shift`` blocks
    past the largest corner, holding a copy of a surface block."""
    n, bs = vol.n_blocks, cfg.block_size
    coords = P.unpack_keys(vol.keys[:n].numpy()).astype(np.int64)
    t = vol.tsdf[:n].numpy()
    src = int(np.argmax((t < 0).any(1) & (t > 0).any(1)
                        & (vol.weight[:n].numpy() > 0).all(1)))
    out = coords.max(axis=0) + shift
    c = torch.from_numpy(np.concatenate([coords, out[None]]))
    blocks = [torch.cat([a[:n], a[src:src + 1]]).reshape(
        (n + 1, bs, bs, bs) + a.shape[2:]) for a in (vol.tsdf, vol.weight,
                                                     vol.color)]
    return c, blocks


def test_searchsorted_lookup_equals_slot_grid(fused, monkeypatch):
    _, _, vol = fused
    coords, (t, w, c) = with_outlier(vol, PCFG, 40)
    args = (coords, t, w, c, PCFG.origin, PCFG.voxel_size, PCFG.block_size)
    grid = P.marching_tetrahedra_blocks(*args)
    monkeypatch.setattr(p_marching, "SLOT_GRID_LIMIT", 0)
    sorted_ = P.marching_tetrahedra_blocks(*args)
    for a, b in zip(grid, sorted_):
        np.testing.assert_array_equal(a, b)
    assert grid.faces.shape[0] > 2000


def test_far_outlier_block_takes_the_sorted_lookup(fused):
    """An outlier 400 blocks out makes the box 400^3 > SLOT_GRID_LIMIT
    cells; the mesh is the near-outlier mesh with the outlier's vertices
    moved (same faces, the other vertices bit for bit)."""
    _, _, vol = fused
    near_c, blocks = with_outlier(vol, PCFG, 40)
    far_c, _ = with_outlier(vol, PCFG, 400)
    box = (far_c.max(0).values - far_c.min(0).values + 1).prod()
    assert int(box) > p_marching.SLOT_GRID_LIMIT
    rest = P.marching_tetrahedra_blocks(
        near_c[:-1], *(b[:-1] for b in blocks), PCFG.origin,
        PCFG.voxel_size, PCFG.block_size)
    near, far = (P.marching_tetrahedra_blocks(
        c, *blocks, PCFG.origin, PCFG.voxel_size, PCFG.block_size)
        for c in (near_c, far_c))
    np.testing.assert_array_equal(near.faces, far.faces)
    k = rest.vertices.shape[0]
    assert near.vertices.shape[0] > k
    np.testing.assert_array_equal(far.vertices[:k], near.vertices[:k])
    np.testing.assert_array_equal(far.vertex_colors, near.vertex_colors)
    shift = (400 - 40) * PCFG.block_extent
    np.testing.assert_allclose(far.vertices[k:] - near.vertices[k:], shift,
                               atol=1e-4)


# ---- mesh post-processing against JAX's (native cluster order)

@pytest.fixture(scope="module")
def fused_mesh(fused):
    _, _, vol = fused
    return P.extract_triangle_mesh(vol, PCFG)


@pytest.mark.parametrize("case", ["fused", "fused_shuffled", "two_tets"])
def test_cluster_labels_match_jax_native_order(fused_mesh, case):
    from gs2mesh_tpu import native

    assert native.available()
    if case == "two_tets":
        mesh, _ = two_tetrahedra()
        faces, nv = mesh.faces, mesh.vertices.shape[0]
    else:
        faces, nv = fused_mesh.faces, fused_mesh.vertices.shape[0]
        if case == "fused_shuffled":
            faces = faces[np.random.default_rng(0).permutation(len(faces))]
    labels, counts = P.cluster_connected_triangles(faces, nv)
    jl, jc = j_mesh.cluster_connected_triangles(faces, nv)
    assert labels.dtype == np.int64 and counts.dtype == np.int64
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(counts, jc)
    assert len(counts) >= 2


def test_clean_mesh_matches_jax(fused_mesh):
    for thres in (1, 30, 10_000):
        a = P.clean_mesh(fused_mesh, min_triangles=thres)
        b = J.clean_mesh(fused_mesh, min_triangles=thres)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    scaled = P.scale_mesh(fused_mesh, 0.1)
    np.testing.assert_array_equal(scaled.vertices,
                                  J.scale_mesh(fused_mesh, 0.1).vertices)
    np.testing.assert_array_equal(P.mesh_edges(fused_mesh.faces),
                                  J.mesh_edges(fused_mesh.faces))
    np.testing.assert_allclose(
        p_mesh.recompute_normals(scaled).vertex_normals,
        j_mesh.recompute_normals(scaled).vertex_normals, atol=1e-6, rtol=0)


def test_write_mesh_bytes_equal_jax(tmp_path, fused_mesh):
    mesh = fused_mesh._replace(vertex_colors=fused_mesh.vertex_colors * 1.1)
    P.write_mesh(str(tmp_path / "port.ply"), mesh)
    J.write_mesh(str(tmp_path / "jax.ply"), mesh)
    a = (tmp_path / "port.ply").read_bytes()
    assert a == (tmp_path / "jax.ply").read_bytes()
    d = j_read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(d.faces, mesh.faces)


def test_empty_volume_gives_empty_mesh():
    vol = P.create_volume(PCFG._replace(block_capacity=16), "cpu")
    for dense in (False, True):
        m = P.extract_triangle_mesh(vol, PCFG, dense=dense)
        assert m.vertices.shape == (0, 3) and m.faces.shape == (0, 3)
    assert vol.n_blocks == 0 and not vol.overflow
