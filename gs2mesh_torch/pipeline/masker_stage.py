"""Object-masking contract: every view NNN/ gets a boolean ``left_mask.npy``
(+ png) that the TSDF stage reads, and the close + erode morphology it
applies.

Port of gs2mesh_tpu pipeline/masker_stage.py (the reference's
gs2mesh_utils/masker_utils.py): ``CopyMasker`` (dataset-provided masks, the
DTU/MobileBrick path of run_single.py:119-147) and ``FullMasker``
(all-ones masks for mask-free datasets). The PNG is written by the port's
own writer (``core/png.py``). The SAM2 masker is not ported yet.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from gs2mesh_torch.core.png import write_png


# ------------------------------------------------------------- morphology

def _binary_dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary dilation with a k x k ones kernel (edge behavior identical to
    cv2 BORDER_CONSTANT(0) for dilation of binary masks)."""
    if k <= 1:
        return mask
    out = mask.astype(bool)
    pad_l = (k - 1) // 2
    pad_r = k - 1 - pad_l
    padded = np.pad(out, ((pad_l, pad_r), (pad_l, pad_r)))
    windows = np.lib.stride_tricks.sliding_window_view(padded, (k, k))
    return windows.any(axis=(-1, -2))


def _binary_erode(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary erosion with a k x k ones kernel. cv2.erode pads with the
    REPLICATED border (BORDER_CONSTANT+max for erode is +inf), i.e. border
    pixels are eroded only by in-image zeros; replicate-pad reproduces it."""
    if k <= 1:
        return mask
    out = mask.astype(bool)
    pad_l = (k - 1) // 2
    pad_r = k - 1 - pad_l
    padded = np.pad(out, ((pad_l, pad_r), (pad_l, pad_r)), mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (k, k))
    return windows.all(axis=(-1, -2))


def morph_close_erode(mask: np.ndarray, closing_kernel_size: int,
                      erosion_kernel_size: int) -> np.ndarray:
    """MORPH_CLOSE (dilate+erode) then erode — the TSDF mask treatment
    (tsdf_utils.py:72-77)."""
    closed = _binary_erode(_binary_dilate(mask, closing_kernel_size),
                           closing_kernel_size)
    return _binary_erode(closed, erosion_kernel_size)


# ------------------------------------------------------------ base masker

class Masker:
    """Base masker: writes left_mask.npy/png per view."""

    def __init__(self, renderer):
        self.renderer = renderer

    def save_mask(self, camera_number: int, mask: np.ndarray) -> None:
        out_dir = self.renderer.render_folder_name(camera_number)
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "left_mask.npy"), mask.astype(bool))
        write_png(os.path.join(out_dir, "left_mask.png"),
                  mask.astype(np.uint8) * 255)

    def segment(self) -> None:
        raise NotImplementedError


class CopyMasker(Masker):
    """Per-view masks from a user-supplied loader (DTU/MobileBrick path:
    run_single.py:119-147 copies dataset mask files)."""

    def __init__(self, renderer, load_mask: Callable[[int], np.ndarray]):
        super().__init__(renderer)
        self.load_mask = load_mask

    def segment(self) -> None:
        for i in range(len(self.renderer)):
            self.save_mask(i, self.load_mask(i))


class FullMasker(Masker):
    """All-ones masks (mask-free datasets still get a valid contract)."""

    def segment(self) -> None:
        for i in range(len(self.renderer)):
            cam = self.renderer.left_cameras[i]
            self.save_mask(i, np.ones((cam["height"], cam["width"]), bool))
