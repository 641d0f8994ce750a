"""Dataset preprocessors.

Ports of preprocess_tnt.py:38-56, preprocess_mobilebrick.py:22-30,
preprocess_mipnerf360.py:15-27. COLMAP runs as an external binary where the
reference invokes it. The port's copy of gs2mesh_tpu cli/preprocess.py; it
reads an image's size from its PNG or JPEG header (image_size) where the
JAX module opens the image with PIL.
"""

from __future__ import annotations

import os
import shutil
import struct

from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.sfm import (create_mobile_brick_colmap_files,
                             run_colmap_known_poses)

TNT_SCANS = ["Barn", "Caterpillar", "Truck", "Ignatius"]
MOBILEBRICK_SCANS = ["aston", "audi", "beetles", "big_ben", "boat", "bridge",
                     "cabin", "camera", "castle", "colosseum", "convertible",
                     "ferrari", "jeep", "london_bus", "motorcycle",
                     "porsche", "satellite", "space_shuttle"]
MIPNERF_SCANS = ["counter", "garden", "bicycle", "bonsai", "kitchen"]
# JPEG start-of-frame markers (baseline, progressive, lossless, arithmetic);
# C4, C8 and CC are other segments.
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
             0xCD, 0xCE, 0xCF}


def image_size(path: str):
    """(width, height) of a PNG (its IHDR) or JPEG (its start-of-frame
    segment) without decoding the pixels; any other file raises."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        f.seek(2)
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":                # fill bytes
                marker = f.read(1)
            if not marker:
                break
            code = marker[0]
            if code == 0x01 or 0xD0 <= code <= 0xD9:  # no length field
                continue
            seg = f.read(2)
            if len(seg) < 2:
                break
            (length,) = struct.unpack(">H", seg)
            if code in _JPEG_SOF:
                sof = f.read(5)                     # precision, height, width
                if len(sof) < 5:
                    break
                height, width = struct.unpack(">HH", sof[1:5])
                return width, height
            f.seek(length - 2, os.SEEK_CUR)
    raise ValueError(f"{path}: no JPEG start-of-frame segment")


def _clean_tnt_directory(dir_path: str) -> None:
    for item in ("images_raw", "stereo", "pinhole_dict.json",
                 "run-colmap-geometric.sh", "run-colmap-photometric.sh",
                 "scene.json"):
        p = os.path.join(dir_path, item)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


def preprocess_tnt(base_dir: str, scans=None) -> None:
    """TNT: COLMAP-with-known-poses via the SfM .log trajectories, then
    model conversion + directory normalization (preprocess_tnt.py).

    Requires the COLMAP binary and the neuralangelo-style convert script
    behavior: build a COLMAP model from <scan>_COLMAP_SfM.log poses and
    triangulate. Here we synthesize the known-pose model directly from the
    .log trajectories and run point_triangulator."""
    import numpy as np

    from gs2mesh_torch.core.transforms import rotmat2qvec_wxyz
    from gs2mesh_torch.evals.tnt import read_trajectory

    for scan in scans or TNT_SCANS:
        scan_path = os.path.join(base_dir, "data", "TNT", scan)
        traj = read_trajectory(os.path.join(scan_path,
                                            f"{scan}_COLMAP_SfM.log"))
        images_dir = os.path.join(scan_path, "images")
        image_files = sorted(os.listdir(images_dir))
        assert len(image_files) >= len(traj), (len(image_files), len(traj))

        W, H = image_size(os.path.join(images_dir, image_files[0]))
        # Nominal pinhole intrinsics; point_triangulator refines poses only,
        # so focal comes from the dataset's standard capture geometry.
        focal = 0.7 * W

        sparse = os.path.join(scan_path, "sparse", "0")
        os.makedirs(sparse, exist_ok=True)
        cams, imgs = {}, {}
        for i, (pose, name) in enumerate(zip(traj, image_files)):
            w2c = np.linalg.inv(pose.pose)
            imgs[i + 1] = colmap_io.ColmapImage(
                id=i + 1, qvec=rotmat2qvec_wxyz(w2c[:3, :3]),
                tvec=w2c[:3, 3], camera_id=1, name=name,
                xys=np.zeros((0, 2)),
                point3D_ids=np.zeros((0,), np.int64))
        cams[1] = colmap_io.ColmapCamera(
            id=1, model="PINHOLE", width=W, height=H,
            params=np.array([focal, focal, W / 2.0, H / 2.0]))
        colmap_io.write_cameras_text(os.path.join(sparse, "cameras.txt"),
                                     cams)
        colmap_io.write_images_text(os.path.join(sparse, "images.txt"), imgs)
        open(os.path.join(sparse, "points3D.txt"), "w").close()

        run_colmap_known_poses(scan_path)
        _clean_tnt_directory(scan_path)


def preprocess_mobilebrick(base_dir: str, scans=None) -> None:
    for scan in scans or MOBILEBRICK_SCANS:
        colmap_dir = os.path.join(base_dir, "data", "MobileBrick", scan)
        print(scan)
        if os.path.exists(os.path.join(colmap_dir, "image")):
            os.rename(os.path.join(colmap_dir, "image"),
                      os.path.join(colmap_dir, "images"))
        create_mobile_brick_colmap_files(colmap_dir, scan)
        run_colmap_known_poses(colmap_dir)


def preprocess_mipnerf360(base_dir: str, scans=None) -> None:
    for scan in scans or MIPNERF_SCANS:
        colmap_dir = os.path.join(base_dir, "data", "MipNerf360", scan)
        print(scan)
        colmap_io.convert_bin_to_text(os.path.join(colmap_dir, "sparse",
                                                   "0"))
