"""Parity of the PyTorch port's data and loss modules with the JAX package,
on the CPU: COLMAP binary IO, the PNG reader, load_colmap_scene, the SSIM
loss and the 3-NN scale initialisation."""

import math
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gs2mesh_tpu.core import colmap_io as jcolmap
from gs2mesh_tpu.core.transforms import rotmat2qvec_wxyz
from gs2mesh_tpu.ops import knn as jknn
from gs2mesh_tpu.ops import ssim as jssim
from gs2mesh_tpu.train.scene import load_colmap_scene as j_load_colmap_scene
from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.ops import knn, ssim
from gs2mesh_torch.train.scene import load_colmap_scene
from tests.test_torch_core import assert_camera_close

torch.set_num_threads(1)


def jax_model(rng, n_images=3, n_points=5):
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                    np.array([60.0, 62.0, 32.0, 24.0])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_RADIAL", 64, 48,
                                    np.array([58.0, 32.0, 24.0, 0.01]))}
    imgs = {}
    for i in range(1, n_images + 1):
        eye = np.array([math.sin(0.4 * i), 0.1 * i, -math.cos(0.4 * i)]) * 3
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        imgs[i] = jcolmap.ColmapImage(
            i, rotmat2qvec_wxyz(R), -R @ eye, 1 + i % 2, f"{i:03}.png",
            rng.uniform(0, 60, size=(i, 2)), np.arange(i, dtype=np.int64) - 1)
    pts = {7 + k: jcolmap.ColmapPoint3D(
        7 + k, rng.normal(size=3), rng.integers(0, 256, size=3), 0.5,
        np.arange(k, dtype=np.int64), np.arange(k, dtype=np.int64) + 2)
        for k in range(n_points)}
    return cams, imgs, pts


def as_port(cams, imgs, pts):
    return ({k: colmap_io.ColmapCamera(**vars(v)) for k, v in cams.items()},
            {k: colmap_io.ColmapImage(**vars(v)) for k, v in imgs.items()},
            {k: colmap_io.ColmapPoint3D(**vars(v)) for k, v in pts.items()})


def test_colmap_binary_matches_jax(tmp_path):
    """The port reads what the JAX package writes and writes the same
    bytes; read_model prefers .bin over .txt as the JAX package does."""
    cams, imgs, pts = jax_model(np.random.default_rng(5))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    jcolmap.write_cameras_binary(os.path.join(jdir, "cameras.bin"), cams)
    jcolmap.write_images_binary(os.path.join(jdir, "images.bin"), imgs)
    jcolmap.write_points3D_binary(os.path.join(jdir, "points3D.bin"), pts)
    jcolmap.write_model_text(jdir, {}, {}, {})     # .bin must win
    colmap_io.write_model_binary(tdir, *as_port(cams, imgs, pts))
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f
    for got, ref in zip(colmap_io.read_model(jdir), jcolmap.read_model(jdir)):
        assert got.keys() == ref.keys() and len(got) > 0
        for k in got:
            for field, v in vars(ref[k]).items():
                np.testing.assert_array_equal(getattr(got[k], field), v,
                                              err_msg=field)
    os.remove(os.path.join(tdir, "points3D.bin"))
    assert colmap_io.read_model(tdir)[2] == {}


def encode_png(img: np.ndarray, filters, ctype=None, depth=8,
               interlace=0) -> bytes:
    """Test encoder: (H, W, C) uint8 with the given filter type per row."""
    h, w, c = img.shape
    bpp = c
    raw = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        cprev = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            out = cur
        elif ft == 1:
            out = cur - a
        elif ft == 2:
            out = cur - prev
        elif ft == 3:
            out = cur - (a + prev) // 2
        else:
            p = a + prev - cprev
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cprev)
            out = cur - np.where((pa <= pb) & (pa <= pc), a,
                                 np.where(pb <= pc, prev, cprev))
        raw += bytes([ft]) + (out & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = ctype if ctype is not None else {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_all_filters(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(11, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(path), img)
    # A file from another encoder (adaptive filters) decodes as it does.
    Image.fromarray(img).save(path, optimize=True)
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))
    write_png(path, img[..., :3].copy())
    np.testing.assert_array_equal(read_png(path), img[..., :3])


@pytest.mark.parametrize("kind", ["gray", "16bit", "interlaced", "notpng"])
def test_png_reader_rejects_other_formats(tmp_path, kind):
    img = np.zeros((4, 4, 3), np.uint8)
    data = {"gray": encode_png(img[..., :1], [0], ctype=0),
            "16bit": encode_png(img, [0], depth=16),
            "interlaced": encode_png(img, [0], interlace=1),
            "notpng": b"GIF89a" + bytes(40)}[kind]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        read_png(path)


def test_load_colmap_scene_matches_jax(tmp_path):
    """Cameras, images, points, colours and the NeRF++ normalisation of the
    same written scene (binary model, PNG images), with the eval split."""
    rng = np.random.default_rng(3)
    cams, imgs, pts = jax_model(rng, n_images=5, n_points=40)
    root = str(tmp_path)
    jcolmap.write_model_text(os.path.join(root, "sparse", "0"), {}, {}, {})
    colmap_io.write_model_binary(os.path.join(root, "sparse", "0"),
                                 *as_port(cams, imgs, pts))
    os.makedirs(os.path.join(root, "images"))
    for im in imgs.values():
        write_png(os.path.join(root, "images", im.name),
                  rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8))
    ref = j_load_colmap_scene(root, eval_split=True, llffhold=2)
    got = load_colmap_scene(root, eval_split=True, llffhold=2, device="cpu")
    assert len(got.cameras) == len(ref.cameras) == 5
    for c, jc in zip(got.cameras, ref.cameras):
        assert_camera_close(c, jc)
    for a, b in zip(got.images, ref.images):
        np.testing.assert_array_equal(a, b)
    for f in ("points", "colors", "nerf_norm_translate"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.nerf_norm_radius == ref.nerf_norm_radius
    assert (got.train_indices, got.test_indices) == (ref.train_indices,
                                                     ref.test_indices)


def test_ssim_gs_loss_psnr_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 40, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, ref in ((ssim.ssim(ta, tb), jssim.ssim(ja, jb)),
                     (ssim.gs_loss(ta, tb), jssim.gs_loss(ja, jb)),
                     (ssim.gs_loss(ta, tb, 0.5), jssim.gs_loss(ja, jb, 0.5)),
                     (ssim.psnr(ta, tb), jssim.psnr(ja, jb)),
                     (ssim.l2_loss(ta, tb), jssim.l2_loss(ja, jb))):
        assert float(got) == pytest.approx(float(ref), rel=1e-6, abs=1e-6)
    assert float(ssim.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)


def test_knn_matches_jax():
    """mean_sq_dist_3nn against the JAX package's on the same points (the
    candidate windows come from the same Morton orders), and both against
    the exact 3-NN distances."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(512, 3)).astype(np.float32)
    got = knn.mean_sq_dist_3nn(torch.from_numpy(pts)).numpy()
    ref = np.asarray(jknn.mean_sq_dist_3nn(jnp.asarray(pts)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    exact = knn.mean_sq_dist_3nn_exact(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(
        exact, np.asarray(jknn.mean_sq_dist_3nn_exact(jnp.asarray(pts))),
        rtol=1e-6)
    assert np.median(np.abs(got - exact) / exact) < 0.02
    np.testing.assert_array_equal(
        knn.morton_codes(torch.from_numpy(pts)).numpy(),
        np.asarray(jknn.morton_codes(jnp.asarray(pts))))
