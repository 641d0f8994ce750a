"""Object-masking contract: every view NNN/ gets a boolean ``left_mask.npy``
(+ png) that the TSDF stage reads, and the close + erode morphology it
applies.

Port of gs2mesh_tpu pipeline/masker_stage.py (the reference's
gs2mesh_utils/masker_utils.py): ``CopyMasker`` (dataset-provided masks, the
DTU/MobileBrick path of run_single.py:119-147) and ``FullMasker``
(all-ones masks for mask-free datasets) and ``SAM2Masker`` (SAM2 video
propagation from a view-0 box or points: given, GroundingDINO's box for a
text prompt, or the whole image; gs2mesh_utils/masker_utils.py:42-359).
PNGs are read and written by the port's own codec (``core/png.py``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

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


class SAM2Masker(Masker):
    """SAM2 video mask propagation (masker_utils.py:42-359) on the port's
    SAM2 (gs2mesh_torch.sam2). The view-0 prompt is, in this order: an
    explicit ``box`` / ``points`` seed; the best box GroundingDINO
    (gs2mesh_torch.gdino) finds for the text ``prompt`` when a
    ``gdino_checkpoint`` file (the released groundingdino_swint_ogc.pth)
    exists, the caption tokenized with the ``gdino_vocab`` vocab.txt; a
    whole-image box (2% margins)."""

    def __init__(self, renderer, prompt: str = "main_object",
                 box: Optional[np.ndarray] = None,
                 points: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None,
                 box_threshold: float = 0.35, text_threshold: float = 0.25,
                 sam2_checkpoint: Optional[str] = None, sam2_model=None,
                 gdino_checkpoint: Optional[str] = None,
                 gdino_vocab: Optional[str] = None, device="cuda"):
        super().__init__(renderer)
        self.prompt = prompt
        self.box = box
        self.points = points
        self.labels = labels
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        self._gdino_ckpt = gdino_checkpoint
        self._gdino_vocab = gdino_vocab
        self._gdino = None

        from gs2mesh_torch.sam2 import (SAM2Config, SAM2VideoPredictor,
                                        load_sam2_checkpoint)

        if sam2_model is None:
            if sam2_checkpoint is None:
                raise ValueError(
                    "SAM2Masker needs sam2_model or sam2_checkpoint "
                    "(a released sam2_hiera_*.pt file)")
            name = os.path.basename(sam2_checkpoint)
            presets = {"tiny": SAM2Config.tiny, "small": SAM2Config.small,
                       "base_plus": SAM2Config.base_plus,
                       "large": SAM2Config.large}
            cfg = next((v() for k, v in presets.items() if k in name),
                       SAM2Config.large())
            sam2_model = load_sam2_checkpoint(sam2_checkpoint, cfg)
        self.predictor = SAM2VideoPredictor(sam2_model, device=device)

    def _gdino_box(self, img: np.ndarray) -> Optional[np.ndarray]:
        """GroundingDINO's best box for ``prompt`` on ``img`` as pixel xyxy
        (masker_utils.py:133-162), or None when the checkpoint file is
        missing or no box passes ``box_threshold``. The model and the
        tokenizer load once, the model onto the masker's device."""
        if not self._gdino_ckpt or not os.path.exists(self._gdino_ckpt):
            return None
        from gs2mesh_torch.gdino import (best_box_xyxy, load_gdino_checkpoint,
                                         load_tokenizer, predict)

        if self._gdino is None:
            model = load_gdino_checkpoint(self._gdino_ckpt)
            self._gdino = (model.to(self.predictor.core.device).eval(),
                           load_tokenizer(self._gdino_vocab))
        model, tokenizer = self._gdino
        boxes, scores, _ = predict(model, img, caption=self.prompt,
                                   box_threshold=self.box_threshold,
                                   text_threshold=self.text_threshold,
                                   tokenizer=tokenizer)
        return best_box_xyxy(boxes, scores, img.shape[:2])

    def preview_mask(self, image: np.ndarray, points=None, labels=None,
                     box=None) -> np.ndarray:
        """The best-IoU mask of the SAM2 image predictor on the current
        seeds, for an interactive redraw (masker_utils.py:269-300)."""
        from gs2mesh_torch.sam2 import SAM2ImagePredictor

        if getattr(self, "_img_predictor", None) is None:
            self._img_predictor = SAM2ImagePredictor(
                self.predictor.core.model, device=self.predictor.core.device)
            self._img_predictor_image = None
        pred = self._img_predictor
        if self._img_predictor_image is not image:
            pred.set_image(image)
            self._img_predictor_image = image
        masks, ious, _ = pred.predict(point_coords=points,
                                      point_labels=labels, box=box)
        return masks[int(np.argmax(ious))]

    def segment(self) -> None:
        from gs2mesh_torch.sam2.predictor import read_frame

        frames = [read_frame(os.path.join(
            self.renderer.render_folder_name(i), "left.png"))
            for i in range(len(self.renderer))]
        state = self.predictor.init_state(frames=frames)
        box = self.box
        if box is None and self.points is None and self._gdino_ckpt:
            box = self._gdino_box(frames[0])
        if box is None and self.points is None:
            h, w = frames[0].shape[:2]
            box = np.array([0.02 * w, 0.02 * h, 0.98 * w, 0.98 * h])
        self.predictor.add_new_points_or_box(
            state, frame_idx=0, obj_id=0, box=box, points=self.points,
            labels=self.labels)
        for frame_idx, _, logits in self.predictor.propagate_in_video(state):
            self.save_mask(frame_idx, logits[0, 0] > 0.0)


SAM2_CHECKPOINT = os.path.join("third_party", "segment-anything-2",
                               "checkpoints", "sam2_hiera_large.pt")


def init_predictor(base_dir, renderer, args, sam2_checkpoint=None,
                   gdino_checkpoint=None, device="cuda", **kw):
    """Factory of masker_utils.init_predictor (masker_utils.py:42-69): the
    text prompt from ``args``, ``gdino_checkpoint`` passed through. With
    no ``sam2_checkpoint`` it takes the reference's
    ``<base_dir>/third_party/segment-anything-2/checkpoints/
    sam2_hiera_large.pt`` where that file exists (SAM2Masker raises
    without weights)."""
    default = os.path.join(base_dir, SAM2_CHECKPOINT)
    if sam2_checkpoint is None and os.path.exists(default):
        sam2_checkpoint = default
    return SAM2Masker(renderer,
                      prompt=getattr(args, "masker_prompt", "main_object"),
                      sam2_checkpoint=sam2_checkpoint,
                      gdino_checkpoint=gdino_checkpoint, device=device, **kw)
