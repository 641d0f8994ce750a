"""COLMAP driver: the port's copy of gs2mesh_tpu sfm/colmap_driver.py
(gs2mesh_utils/colmap_utils.py).

COLMAP runs as an external binary (the reference shells out too,
colmap_utils.py:203-233); the model readers/writers live in
gs2mesh_torch.core.colmap_io. Frame extraction needs OpenCV, imported when
it runs. The downsampled image directory is read and written with the
port's PNG codec (core/png.py) and resized by the training loader's
antialiased bicubic (close to, not bit-equal with, PIL's resize); an image
that is not a PNG raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from gs2mesh_torch.core import colmap_io
from gs2mesh_torch.core.transforms import matrix_to_quaternion


def _run(cmd: list) -> None:
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def _require_colmap() -> None:
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "COLMAP binary not found on PATH. Install COLMAP (external "
            "dependency, same as the reference) or run with --skip_colmap "
            "on data that already has a sparse model.")


def extract_frames(video_path: str, output_folder: str, interval: int = 20,
                   verbose: bool = True) -> None:
    """Extract every `interval`-th frame (colmap_utils.py:44-90)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "extracting video frames needs OpenCV (cv2), which is not "
            "installed; extract the frames into images/ yourself and run "
            "with --skip_video_extraction") from e

    if os.path.exists(output_folder):
        if verbose:
            print(f"Output folder {output_folder} exists. Recreating.")
        shutil.rmtree(output_folder)
    os.makedirs(output_folder)

    vidcap = cv2.VideoCapture(video_path)
    if not vidcap.isOpened():
        print("Error: Could not open video.")
        return
    if verbose:
        fps = vidcap.get(cv2.CAP_PROP_FPS)
        print(f"Sample every {interval} frames, target FPS: {fps/interval}")
    success, image = vidcap.read()
    count = 0
    while success:
        if count % interval == 0:
            cv2.imwrite(os.path.join(output_folder, f"IMG_{count:05}.png"),
                        image)
        success, image = vidcap.read()
        count += 1
    if verbose:
        print("Done extracting frames")


def create_downsampled_colmap_dir(colmap_dir: str,
                                  downsample_factor: int) -> str:
    """Downsampled sibling image dir (colmap_utils.py:92-118). PNG only:
    any other image format raises ValueError."""
    from gs2mesh_torch.core.png import read_png, write_png
    from gs2mesh_torch.train.scene import resize_image

    original = os.path.join(colmap_dir, "images")
    out_dir = f"{os.path.normpath(colmap_dir)}_downsample{downsample_factor}"
    out_images = os.path.join(out_dir, "images")
    if (os.path.exists(out_images)
            and len(os.listdir(original)) == len(os.listdir(out_images))):
        return out_dir
    os.makedirs(out_images, exist_ok=True)
    exts = (".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".gif")
    for filename in sorted(os.listdir(original)):
        if not filename.lower().endswith(exts):
            continue
        if not filename.lower().endswith(".png"):
            raise ValueError(f"{filename}: the port downsamples PNG images "
                             f"only")
        image = read_png(os.path.join(original, filename))
        dims = (image.shape[1] // downsample_factor,
                image.shape[0] // downsample_factor)
        write_png(os.path.join(out_images, filename),
                  resize_image(image, *dims))
    return out_dir


def _move_files_to_sparse_zero(colmap_dir: str) -> None:
    sparse = os.path.join(colmap_dir, "sparse")
    zero = os.path.join(sparse, "0")
    os.makedirs(zero, exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        src = os.path.join(sparse, name)
        if os.path.exists(src):
            shutil.move(src, os.path.join(zero, name))


def run_colmap(colmap_dir: str, use_gpu: bool = True) -> None:
    """Unknown-pose SfM: RADIAL single-camera feature extraction ->
    exhaustive matching -> mapping -> PINHOLE undistortion
    (colmap_utils.py:203-233)."""
    _require_colmap()
    images_dir = os.path.join(colmap_dir, "images")
    images_raw = os.path.join(colmap_dir, "images_raw")
    database = os.path.join(colmap_dir, "database.db")
    sparse = os.path.join(colmap_dir, "sparse")
    gpu = "1" if use_gpu else "0"

    os.rename(images_dir, images_raw)
    shutil.rmtree(os.path.join(images_raw, ".ipynb_checkpoints"),
                  ignore_errors=True)
    _run(["colmap", "feature_extractor", "--database_path", database,
          "--image_path", images_raw, "--ImageReader.single_camera", "1",
          "--ImageReader.camera_model", "RADIAL",
          "--SiftExtraction.use_gpu", gpu])
    _run(["colmap", "exhaustive_matcher", "--database_path", database,
          "--SiftMatching.use_gpu", gpu])
    os.makedirs(sparse, exist_ok=True)
    _run(["colmap", "mapper", "--database_path", database,
          "--image_path", images_raw, "--output_path", sparse,
          "--Mapper.num_threads", "16", "--Mapper.init_min_tri_angle", "4",
          "--Mapper.multiple_models", "0", "--Mapper.extract_colors", "0"])
    zero = os.path.join(sparse, "0")
    for f in os.listdir(zero):
        shutil.move(os.path.join(zero, f), sparse)
    os.rmdir(zero)
    _run(["colmap", "image_undistorter", "--image_path", images_raw,
          "--input_path", sparse, "--output_path", colmap_dir,
          "--output_type", "COLMAP"])
    _move_files_to_sparse_zero(colmap_dir)
    colmap_io.convert_bin_to_text(os.path.join(colmap_dir, "sparse", "0"))


def run_colmap_known_poses(colmap_dir: str, use_gpu: bool = True,
                           images_dir_name: str = "images") -> None:
    """Known-pose triangulation (colmap_utils.py:235-255)."""
    _require_colmap()
    database = os.path.join(colmap_dir, "database.db")
    zero = os.path.join(colmap_dir, "sparse", "0")
    gpu = "1" if use_gpu else "0"
    images = os.path.join(colmap_dir, images_dir_name)
    shutil.rmtree(os.path.join(images, ".ipynb_checkpoints"),
                  ignore_errors=True)
    _run(["colmap", "feature_extractor", "--database_path", database,
          "--image_path", images, "--SiftExtraction.use_gpu", gpu,
          "--ImageReader.camera_model", "PINHOLE"])
    _run(["colmap", "exhaustive_matcher", "--database_path", database,
          "--SiftMatching.use_gpu", gpu])
    _run(["colmap", "point_triangulator", "--clear_points", "1",
          "--database_path", database, "--image_path", images,
          "--input_path", zero, "--output_path", zero])
    colmap_io.convert_bin_to_text(zero)


def create_mobile_brick_colmap_files(orig_dir: str, colmap_name: str) -> None:
    """Synthesize an empty COLMAP model from MobileBrick ARKit poses
    (colmap_utils.py:257-303)."""
    sparse_folder = os.path.join(orig_dir, "sparse", "0")
    os.makedirs(sparse_folder, exist_ok=True)

    extrinsics_dir = os.path.join(orig_dir, "pose")
    intrinsics_dir = os.path.join(orig_dir, "intrinsic")
    images_dir = os.path.join(orig_dir, "images")
    shutil.rmtree(os.path.join(images_dir, ".ipynb_checkpoints"),
                  ignore_errors=True)

    def listing(d):
        return sorted(f for f in os.listdir(d)
                      if os.path.isfile(os.path.join(d, f)))

    extrinsics_files = listing(extrinsics_dir)
    intrinsics_files = listing(intrinsics_dir)
    image_files = listing(images_dir)

    with open(os.path.join(sparse_folder, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i, (efile, image_file) in enumerate(zip(extrinsics_files,
                                                    image_files)):
            extrinsic = np.loadtxt(os.path.join(extrinsics_dir, efile))
            extrinsic = np.linalg.inv(extrinsic)
            qx, qy, qz, qw = matrix_to_quaternion(extrinsic[:3, :3])
            tx, ty, tz = extrinsic[:3, 3]
            f.write(f"{i+1} {qw} {qx} {qy} {qz} {tx} {ty} {tz} "
                    f"{i+1} {image_file}\n\n")

    with open(os.path.join(sparse_folder, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i, ifile in enumerate(intrinsics_files):
            K = np.loadtxt(os.path.join(intrinsics_dir, ifile))
            f.write(f"{i+1} PINHOLE 1920 1440 {K[0, 0]} {K[1, 1]} "
                    f"{K[0, 2]} {K[1, 2]}\n")

    open(os.path.join(sparse_folder, "points3D.txt"), "w").close()
