"""Interactive point / box seeding of the SAM2 masker, the port of
gs2mesh_tpu pipeline/masker_ui.py (masker_utils.py:184-267).

The reference notebook (custom_data.ipynb) seeds SAM2 with matplotlib mouse
interaction on the first rendered view:

  * left-click          -> positive point
  * right-click         -> negative point
  * left-click + drag   -> bounding box (replaces the previous box)
  * middle-click        -> remove the nearest box edge (within 20 px) or
                           else the nearest point

``InteractiveSeeder`` is headless: its on_click / on_release handlers take
any object with ``inaxes``, ``xdata``, ``ydata`` and ``button``, and its
state is plain arrays. ``run_interactive_masker`` wires it to a matplotlib
figure (imported when it runs), previews the SAM2 image predictor's mask
after every edit, and on closing the window runs the video propagation with
the collected seeds.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


class InteractiveSeeder:
    """Click / drag seed collection with the reference's semantics."""

    drag_threshold = 5.0            # px: below = click, above = drag
    remove_threshold = 20.0         # px: middle-click box-edge removal

    def __init__(self, image: np.ndarray,
                 preview_fn: Optional[Callable] = None):
        self.image = image
        self.preview_fn = preview_fn
        self.points: list[tuple[tuple[float, float], int]] = []
        self.bboxes: Optional[np.ndarray] = None   # (4,) xyxy or None
        self.mask: Optional[np.ndarray] = None
        self.drag_start = None
        self.dragging = False
        self.ax = None
        self.fig = None

    # -- event handlers (masker_utils.py:184-227) --------------------------
    def on_click(self, event) -> None:
        if self.ax is not None and event.inaxes != self.ax:
            return
        self.drag_start = (event.xdata, event.ydata)
        self.dragging = True

    def on_release(self, event) -> None:
        if not self.dragging or (self.ax is not None
                                 and event.inaxes != self.ax):
            self.dragging = False
            return
        drag_end = (event.xdata, event.ydata)
        dist = np.hypot(drag_end[0] - self.drag_start[0],
                        drag_end[1] - self.drag_start[1])
        if dist < self.drag_threshold:           # click
            if event.button == 1:
                self.points.append((self.drag_start, 1))
            elif event.button == 3:
                self.points.append((self.drag_start, 0))
            elif event.button == 2:
                if not self.remove_bbox_if_near(*self.drag_start):
                    self.remove_point(*self.drag_start)
        elif event.button == 1:                  # drag -> box
            self.bboxes = np.array([self.drag_start[0], self.drag_start[1],
                                    drag_end[0], drag_end[1]])
        self.dragging = False
        self.redraw()

    def remove_bbox_if_near(self, x: float, y: float) -> bool:
        if self.bboxes is None:
            return False
        b = self.bboxes
        near_x = min(abs(x - b[0]), abs(x - b[2])) < self.remove_threshold
        near_y = min(abs(y - b[1]), abs(y - b[3])) < self.remove_threshold
        if near_x or near_y:
            self.bboxes = None
            return True
        return False

    def remove_point(self, x: float, y: float) -> None:
        if not self.points:
            return
        i = min(range(len(self.points)),
                key=lambda i: (self.points[i][0][0] - x) ** 2
                + (self.points[i][0][1] - y) ** 2)
        self.points.pop(i)

    # -- seeds and drawing -------------------------------------------------
    def seeds(self):
        """(points (N, 2) | None, labels (N,) | None, box (4,) | None)."""
        if self.points:
            pts = np.array([p for p, _ in self.points], np.float32)
            lbl = np.array([l for _, l in self.points], np.int32)
        else:
            pts = lbl = None
        return pts, lbl, self.bboxes

    def redraw(self, visualize: bool = True) -> None:
        if self.preview_fn is not None:
            pts, lbl, box = self.seeds()
            if pts is not None or box is not None:
                self.mask = self.preview_fn(self.image, pts, lbl, box)
        if visualize and self.ax is not None:
            self._draw()

    def _draw(self) -> None:
        from matplotlib.patches import Rectangle

        self.ax.clear()
        self.ax.imshow(self.image)
        if self.mask is not None:
            overlay = np.zeros(self.mask.shape + (4,), np.float32)
            overlay[self.mask] = (0.12, 0.56, 1.0, 0.55)
            self.ax.imshow(overlay)
        for (x, y), label in self.points:
            self.ax.scatter([x], [y], c="lime" if label else "red",
                            marker="*", s=150, edgecolor="white")
        if self.bboxes is not None:
            x0, y0, x1, y1 = self.bboxes
            self.ax.add_patch(Rectangle((min(x0, x1), min(y0, y1)),
                                        abs(x1 - x0), abs(y1 - y0),
                                        edgecolor="lime", facecolor="none",
                                        lw=2))
        self.ax.set_title("L-click +pt | R-click -pt | drag box | "
                          "M-click remove | close window to segment")
        self.fig.canvas.draw()

    def attach(self, fig, ax) -> None:
        self.fig, self.ax = fig, ax
        fig.canvas.mpl_connect("button_press_event", self.on_click)
        fig.canvas.mpl_connect("button_release_event", self.on_release)
        self._draw()


def run_interactive_masker(renderer, sam2_masker, frame_idx: int = 0,
                           block: bool = True):
    """Show the seed view, collect point / box prompts, then run the SAM2
    video propagation with them (custom_data.ipynb, masker_utils.py:
    269-359). ``sam2_masker``: a ``SAM2Masker``; its image predictor gives
    the live preview (``preview_mask``) and the final seeds replace its
    box / points / labels before ``segment()``. Returns the seeder."""
    import matplotlib.pyplot as plt

    from gs2mesh_torch.sam2.predictor import read_frame

    image = read_frame(os.path.join(renderer.render_folder_name(frame_idx),
                                    "left.png"))

    def preview(img, pts, lbl, box):
        return sam2_masker.preview_mask(img, points=pts, labels=lbl, box=box)

    seeder = InteractiveSeeder(image, preview_fn=preview)
    fig, ax = plt.subplots(figsize=(9, 6))
    seeder.attach(fig, ax)
    plt.show(block=block)

    pts, lbl, box = seeder.seeds()
    sam2_masker.points, sam2_masker.labels = pts, lbl
    sam2_masker.box = box
    sam2_masker.segment()
    return seeder
