"""Interactive visualization: camera frusta, point clouds, meshes, stereo
panels (port of gs2mesh_tpu viz.py).

Parity surface for the reference's plotly tooling (gs2mesh_utils/
third_party/visualization/visualize.py, Renderer.visualize_poses
renderer_utils.py:227-284, TSDF.visualize_mesh tsdf_utils.py:144-182,
visualize_colmap_poses colmap_utils.py:120-171). Uses plotly when
installed, otherwise matplotlib 3-D; both are imported only when a plot is
drawn. The stereo panel reads and writes its PNGs with ``core/png.py`` and
blends in numpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gs2mesh_torch.core.png import read_png, write_png


def camera_frustum_segments(pose_c2w: np.ndarray, vis_depth: float = 0.2,
                            aspect: float = 1.333) -> np.ndarray:
    """(5-point pyramid) wireframe segments for one camera-to-world pose.

    Returns (n_seg, 2, 3) world-space line segments."""
    d = vis_depth
    w = d * aspect * 0.5
    h = d * 0.5
    corners = np.array([[-w, -h, d], [w, -h, d], [w, h, d], [-w, h, d]])
    apex = np.zeros(3)
    pts = np.concatenate([apex[None], corners], axis=0)      # (5, 3)
    R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
    pts = pts @ R.T + t
    segs = []
    for i in range(1, 5):
        segs.append([pts[0], pts[i]])
        segs.append([pts[i], pts[1 + (i % 4)]])
    return np.asarray(segs)


def _have_plotly() -> bool:
    try:
        import plotly  # noqa

        return True
    except ImportError:
        return False


def visualize_poses(poses_w2c: np.ndarray, points: Optional[np.ndarray] = None,
                    inside_mask: Optional[np.ndarray] = None,
                    vis_depth: float = 0.2, subsample: int = 100,
                    show: bool = True, save_path: Optional[str] = None):
    """Pose/point-cloud visualization (Renderer.visualize_poses contract:
    frusta + points split into inside/outside-FOV colors)."""
    poses_c2w = []
    for p in np.asarray(poses_w2c):
        if p.shape[0] == 3:
            p = np.vstack([p, [0, 0, 0, 1]])
        poses_c2w.append(np.linalg.inv(p))
    segments = np.concatenate(
        [camera_frustum_segments(p, vis_depth) for p in poses_c2w], axis=0)

    pts = points[::subsample] if points is not None else None
    mask = inside_mask[::subsample] if inside_mask is not None else None

    if _have_plotly():
        import plotly.graph_objects as go

        traces = []
        xs, ys, zs = [], [], []
        for seg in segments:
            xs += [seg[0, 0], seg[1, 0], None]
            ys += [seg[0, 1], seg[1, 1], None]
            zs += [seg[0, 2], seg[1, 2], None]
        traces.append(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                   line=dict(color="black", width=2),
                                   name="cameras"))
        if pts is not None:
            if mask is not None:
                for sel, color, name in ((mask, "green", "Inside FOV"),
                                         (~mask, "orange", "Outside FOV")):
                    p = pts[sel]
                    traces.append(go.Scatter3d(
                        x=p[:, 0], y=p[:, 1], z=p[:, 2], mode="markers",
                        marker=dict(size=1, color=color), name=name))
            else:
                traces.append(go.Scatter3d(
                    x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                    marker=dict(size=1), name="points"))
        fig = go.Figure(data=traces,
                        layout=go.Layout(scene=dict(aspectmode="data"),
                                         height=800))
        if save_path:
            fig.write_html(save_path)
        if show:
            fig.show()
        return fig

    import matplotlib

    if save_path or not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    for seg in segments:
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c="k", linewidth=0.5)
    if pts is not None:
        c = np.where(mask, "g", "orange") if mask is not None else "b"
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c=c)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show and not save_path:
        plt.show()
    plt.close(fig)
    return fig


def visualize_mesh(vertices: np.ndarray, gt_points: Optional[np.ndarray] = None,
                   subsample: int = 100, show: bool = True,
                   save_path: Optional[str] = None):
    """Mesh-vs-GT point scatter (TSDF.visualize_mesh, tsdf_utils.py:144)."""
    pts = vertices[::subsample]
    if _have_plotly():
        import plotly.graph_objects as go

        traces = [go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                               mode="markers", marker=dict(size=1),
                               name="OURS")]
        if gt_points is not None:
            g = gt_points[::subsample]
            traces.append(go.Scatter3d(x=g[:, 0], y=g[:, 1], z=g[:, 2],
                                       mode="markers", marker=dict(size=1),
                                       name="GT"))
        fig = go.Figure(data=traces,
                        layout=go.Layout(scene=dict(aspectmode="data"),
                                         height=800))
        if save_path:
            fig.write_html(save_path)
        if show:
            fig.show()
        return fig

    import matplotlib

    if save_path or not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, label="OURS")
    if gt_points is not None:
        g = gt_points[::subsample]
        ax.scatter(g[:, 0], g[:, 1], g[:, 2], s=1, label="GT")
    ax.legend()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show and not save_path:
        plt.show()
    plt.close(fig)
    return fig


def _rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of an 8-bit grayscale, RGB or RGBA array."""
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """PIL's Image.blend of two (H, W, 3) uint8 images: im1 + alpha *
    (im2 - im1) in float32, truncated to uint8, as its C loop computes it."""
    if im1.shape != im2.shape:
        raise ValueError(f"images do not match: {im1.shape} {im2.shape}")
    a = im1.astype(np.float32)
    d = (im2.astype(np.int32) - im1.astype(np.int32)).astype(np.float32)
    return (a + np.float32(alpha) * d).astype(np.uint8)


def view_results_panel(output_dir: str, model_name: str,
                       save_path: Optional[str] = None,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """Per-view composite diagnostic panel (Stereo.view_results_single,
    stereo_utils.py:181-236): blended L/R, mask, disparity, occlusion,
    shading side by side, as an (H, W, 3) uint8 array (written to
    save_path as PNG if given). A missing image is filled with uniform
    noise in [0, 255) drawn from ``rng`` (a fresh unseeded generator if
    None)."""
    paths = {
        "left_img": "left.png",
        "right_img": "right.png",
        "object_mask": "left_mask.png",
        "occlusion_mask": f"out_{model_name}/occlusion_mask.png",
        "disparity": f"out_{model_name}/disparity_LR.png",
        "shading": f"out_{model_name}/shading.png",
    }
    images = {}
    size = None
    for name, rel in paths.items():
        p = os.path.join(output_dir, rel)
        if os.path.exists(p):
            images[name] = _rgb(read_png(p))
            size = images[name].shape[:2]
    rng = np.random.default_rng() if rng is None else rng
    for name in paths:
        if name not in images:
            images[name] = rng.integers(0, 255, (size[0], size[1], 3),
                                        dtype=np.uint8)
    images["lr_img"] = blend(images["left_img"], images["right_img"], 0.5)
    row = [images[k] for k in ("lr_img", "object_mask", "disparity",
                               "occlusion_mask", "shading")]
    total_w = sum(im.shape[1] for im in row)
    max_h = max(im.shape[0] for im in row)
    panel = np.zeros((max_h, total_w, 3), np.uint8)
    x = 0
    for im in row:
        panel[:im.shape[0], x:x + im.shape[1]] = im
        x += im.shape[1]
    if save_path:
        write_png(save_path, panel)
    return panel
