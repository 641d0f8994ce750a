"""COLMAP sparse-model IO, text and binary formats (the public COLMAP
file-format spec).

Covers what the pipeline reads: cameras, images (poses + 2D points),
points3D, ``read_model`` (binary preferred, then text) and the
world-to-camera poses in image-id order.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

from gs2mesh_torch.core.transforms import qvec2rotmat_wxyz

CAMERA_MODELS = {
    # model_id: (name, num_params)
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL", "RADIAL_FISHEYE"):
            return float(self.params[0])
        return float(self.params[1])

    @property
    def cx(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL", "RADIAL_FISHEYE"):
            return float(self.params[1])
        return float(self.params[2])

    @property
    def cy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL", "RADIAL_FISHEYE"):
            return float(self.params[2])
        return float(self.params[3])


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray       # (4,) w, x, y, z — world-to-camera rotation
    tvec: np.ndarray       # (3,) world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray        # (N, 2)
    point3D_ids: np.ndarray  # (N,)

    def world_to_cam(self) -> np.ndarray:
        """3x4 [R|t] world-to-camera."""
        R = qvec2rotmat_wxyz(self.qvec)
        return np.concatenate([R, self.tvec.reshape(3, 1)], axis=1)


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


# ---------------------------------------------------------------------------
# Text format
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cam_id, model = int(el[0]), el[1]
            cams[cam_id] = ColmapCamera(
                id=cam_id, model=model, width=int(el[2]), height=int(el[3]),
                params=np.array([float(v) for v in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f
                 if not ln.strip().startswith("#")]
    i, n = 0, len(lines)
    while i < n:
        if not lines[i].strip():          # blanks between records
            i += 1
            continue
        el = lines[i].split()
        img_id = int(el[0])
        qvec = np.array([float(v) for v in el[1:5]])
        tvec = np.array([float(v) for v in el[5:8]])
        cam_id, name = int(el[8]), el[9]
        # The next line is always the POINTS2D list — possibly empty
        # (COLMAP writes it as a blank line).
        el2 = lines[i + 1].split() if i + 1 < n else []
        if el2:
            xys = np.array([float(v) for v in el2]).reshape(-1, 3)[:, :2]
            ids = np.array([int(float(v)) for v in el2[2::3]])
        else:
            xys, ids = np.zeros((0, 2)), np.zeros((0,), dtype=np.int64)
        imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
        i += 2
    return imgs


def read_points3D_text(path: str) -> Dict[int, ColmapPoint3D]:
    pts: Dict[int, ColmapPoint3D] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            pts[pid] = ColmapPoint3D(
                id=pid,
                xyz=np.array([float(v) for v in el[1:4]]),
                rgb=np.array([int(v) for v in el[4:7]]),
                error=float(el[7]),
                image_ids=np.array([int(v) for v in el[8::2]]),
                point2D_idxs=np.array([int(v) for v in el[9::2]]),
            )
    return pts


def write_cameras_text(path: str, cameras: Dict[int, ColmapCamera]) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = []
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                row += [repr(float(x)), repr(float(y)), str(int(pid))]
            f.write(" ".join(row) + "\n")


def write_points3D_text(path: str, points: Dict[int, ColmapPoint3D]) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# ---------------------------------------------------------------------------
# Binary format
# ---------------------------------------------------------------------------

def _read(f, fmt: str):
    return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * nparams))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            name = b""
            while (c := f.read(1)) != b"\x00":
                if not c:
                    raise ValueError(f"{path}: truncated image name")
                name += c
            (npts,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=np.dtype("<f8, <f8, <i8"))
            xys = np.stack([data["f0"], data["f1"]], axis=1)
            ids = data["f2"].astype(np.int64)
            imgs[vals[0]] = ColmapImage(vals[0], np.array(vals[1:5]),
                                        np.array(vals[5:8]), vals[8],
                                        name.decode("utf-8"), xys, ids)
    return imgs


def read_points3D_binary(path: str) -> Dict[int, ColmapPoint3D]:
    pts: Dict[int, ColmapPoint3D] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "QdddBBBd")
            (track_len,) = _read(f, "Q")
            track = np.frombuffer(f.read(8 * track_len),
                                  dtype=np.dtype("<i4, <i4"))
            pts[int(vals[0])] = ColmapPoint3D(
                id=int(vals[0]), xyz=np.array(vals[1:4]),
                rgb=np.array(vals[4:7]), error=float(vals[7]),
                image_ids=track["f0"].astype(np.int64),
                point2D_idxs=track["f1"].astype(np.int64))
    return pts


def write_cameras_binary(path: str, cameras: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params),
                                *[float(p) for p in cam.params]))


def write_images_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id,
                                *[float(v) for v in im.qvec],
                                *[float(v) for v in im.tvec], im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def write_points3D_binary(path: str,
                          points: Dict[int, ColmapPoint3D]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<QdddBBBd", int(p.id),
                                *[float(v) for v in p.xyz],
                                *[int(v) for v in p.rgb], float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))


def read_model(sparse_dir: str):
    """(cameras, images, points) of a COLMAP sparse model directory,
    preferring .bin over .txt; points3D may be absent ({})."""
    def pick(stem, bin_fn, txt_fn):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return bin_fn(b)
        if os.path.exists(t):
            return txt_fn(t)
        raise FileNotFoundError(f"missing {stem}.bin/.txt in {sparse_dir}")

    cameras = pick("cameras", read_cameras_binary, read_cameras_text)
    images = pick("images", read_images_binary, read_images_text)
    try:
        points = pick("points3D", read_points3D_binary, read_points3D_text)
    except FileNotFoundError:
        points = {}
    return cameras, images, points


def write_model_binary(sparse_dir: str, cameras, images, points) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_binary(os.path.join(sparse_dir, "cameras.bin"), cameras)
    write_images_binary(os.path.join(sparse_dir, "images.bin"), images)
    write_points3D_binary(os.path.join(sparse_dir, "points3D.bin"), points)


def write_model_text(sparse_dir: str, cameras, images, points) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_text(os.path.join(sparse_dir, "cameras.txt"), cameras)
    write_images_text(os.path.join(sparse_dir, "images.txt"), images)
    write_points3D_text(os.path.join(sparse_dir, "points3D.txt"), points)


def convert_bin_to_text(sparse_dir: str) -> None:
    """bin -> txt in place (the reference shells out to COLMAP's
    model_converter for this; the port writes the text files itself)."""
    cameras = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    p3d_path = os.path.join(sparse_dir, "points3D.bin")
    points = read_points3D_binary(p3d_path) if os.path.exists(p3d_path) else {}
    write_model_text(sparse_dir, cameras, images, points)


def poses_from_model(images: Dict[int, ColmapImage]) -> np.ndarray:
    """(N, 3, 4) world-to-camera [R|t] sorted by image id
    (the reference sorts by image id; gs2mesh_utils/colmap_utils.py:26-42)."""
    ordered = [images[k] for k in sorted(images.keys())]
    return np.stack([im.world_to_cam() for im in ordered], axis=0)
