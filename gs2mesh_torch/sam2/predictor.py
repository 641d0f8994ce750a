"""SAM2 image and video predictors (host-side state, model calls on the
model's device), the port of gs2mesh_tpu sam2/predictor.py.

A subset of sam2/sam2_{image,video}_predictor.py for the pipeline's masking:
one tracked object, prompted by points and/or a box (the box becomes two
corner points labelled 2 and 3, sam2_video_predictor.py:203-227), carried
through the frames with SAM2's streaming memory (the conditioning frame,
the last num_maskmem-1 frames' spatial memories and up to 15 recent object
pointers, sam2_base.py:494-661).

The image resize of ``preprocess_image`` is the port's own copy of PIL's
BILINEAR resample (no PIL on the card's machine), bit for bit.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Optional

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.core.precision import precision_scope
from gs2mesh_torch.sam2.layers import resize_linear, resize_nearest
from gs2mesh_torch.sam2.model import (SAM2, condition_features,
                                      encode_new_memory, forward_image,
                                      forward_sam_heads, use_mask_as_output)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_PRECISION_BITS = 32 - 8 - 2           # Pillow's Resample.c fixed point


@functools.lru_cache(maxsize=16)
def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the BILINEAR
    (triangle, support 1) filter over the box (0, in_size): per output
    pixel the first source index and int fixed-point weights (out, ksize)."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = sum(w)
        k = [v / ww if ww != 0.0 else v for v in w]
        first[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << _PRECISION_BITS))
                         for v in k]
    return first, kk


def _resample_pass(img: torch.Tensor, axis: int, out_size: int):
    """One 8-bit pass of Pillow's ImagingResample{Horizontal,Vertical}_8bpc
    along ``axis`` of an (H, W, C) uint8 tensor: int32 accumulation from
    1 << 21 (Pillow's own int; 255 x 2^22 fits), then clip8 (>> 22,
    saturated to [0, 255]). Integer arithmetic: the same on every device."""
    in_size = img.shape[axis]
    first, kk = _resample_coeffs(in_size, out_size)
    src = img.to(torch.int32)
    shape = [1] * src.ndim
    shape[axis] = out_size
    acc = None
    for j in range(kk.shape[1]):
        idx = torch.from_numpy(np.minimum(first + j, in_size - 1)).to(
            img.device)                          # weight 0 past the end
        w = torch.from_numpy(kk[:, j].copy()).to(img.device).reshape(shape)
        term = src.index_select(axis, idx) * w
        acc = term + (1 << (_PRECISION_BITS - 1)) if acc is None else \
            acc + term
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def resize_bilinear_uint8(img: torch.Tensor, width: int, height: int):
    """PIL ``Image.fromarray(img).resize((width, height), Image.BILINEAR)``
    of an (H, W, 3) uint8 tensor, bit for bit: a horizontal pass into a
    uint8 intermediate, then a vertical pass (a pass is skipped where the
    size does not change, as in Pillow)."""
    if img.shape[1] != width:
        img = _resample_pass(img, 1, width)
    if img.shape[0] != height:
        img = _resample_pass(img, 0, height)
    return img


def preprocess_image(img: np.ndarray, image_size: int, device):
    """uint8 / float (H, W, 3) -> normalized (1, S, S, 3) float32 tensor on
    ``device``, as SAM2Transforms (utils/transforms.py: square resize +
    ImageNet normalization); the same bits as the JAX package's PIL path
    on every device."""
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.0 else 1.0),
                      0, 255).astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    arr = resize_bilinear_uint8(x, image_size, image_size).to(torch.float32)
    # Divisors as device tensors: CUDA turns a host-scalar divisor into a
    # reciprocal product, which rounds apart from numpy's division.
    arr = arr / torch.tensor(255.0, device=arr.device)
    mean = torch.from_numpy(IMAGENET_MEAN).to(arr.device)
    std = torch.from_numpy(IMAGENET_STD).to(arr.device)
    return ((arr - mean) / std)[None]


def read_frame(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 frame from an 8-bit PNG (gray replicated, alpha
    dropped, as PIL's convert("RGB"))."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


class _Core:
    """The model calls shared by both predictors, on the model's device and
    dtype, in full float32 (TF32 off) or float64."""

    def __init__(self, model: SAM2, device):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.dtype = next(model.parameters()).dtype

    def tensor(self, x):
        return torch.as_tensor(np.asarray(x)).to(self.device)

    @torch.no_grad()
    def encode(self, image: np.ndarray):
        x = preprocess_image(image, self.cfg.image_size, self.device).to(
            self.dtype)
        with precision_scope():
            return forward_image(self.model, x)

    @torch.no_grad()
    def sam_heads(self, feat, high_res, point_coords=None,
                  point_labels=None, mask_inputs=None, multimask=False):
        if point_coords is not None:
            point_coords = self.tensor(point_coords).to(self.dtype)
            point_labels = self.tensor(point_labels).to(torch.int64)
        with precision_scope():
            return forward_sam_heads(
                self.model, feat, point_coords=point_coords,
                point_labels=point_labels, mask_inputs=mask_inputs,
                high_res_features=high_res, multimask_output=multimask)

    def first_frame_feat(self, feat):
        """directly_add_no_mem_embed on an initial conditioning frame
        (sam2_base.py:641-646)."""
        return feat + self.model.no_mem_embed[0, 0].detach()

    @torch.no_grad()
    def conditioned_feat(self, feat, pos, memories, memory_pos, obj_ptrs):
        with precision_scope():
            return condition_features(self.model, feat, pos, memories,
                                      memory_pos, obj_ptrs)

    @torch.no_grad()
    def encode_memory(self, feat, high_res_masks):
        with precision_scope():
            return encode_new_memory(self.model, feat, high_res_masks)


class SAM2ImagePredictor:
    """Single-image prompted segmentation (sam2_image_predictor.py subset)."""

    def __init__(self, model: SAM2, device="cuda"):
        self.core = _Core(model, device)
        self.cfg = model.cfg
        self._feat = None
        self._orig_hw = None

    def set_image(self, image: np.ndarray) -> None:
        self._orig_hw = image.shape[:2]
        feats = self.core.encode(image)["backbone_fpn"]
        self._high_res = [feats[0], feats[1]]
        self._feat = self.core.first_frame_feat(feats[2])

    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output: bool = True):
        """Returns (masks (M, H, W) bool at the original size, ious (M,),
        the (M, S, S) high-res logits) as numpy arrays."""
        assert self._feat is not None, "call set_image first"
        H0, W0 = self._orig_hw
        scale = np.array([self.cfg.image_size / W0,
                          self.cfg.image_size / H0], np.float32)
        pts, labels = [], []
        if box is not None:
            pts.append(np.asarray(box, np.float32).reshape(2, 2) * scale)
            labels.append(np.array([2, 3], np.int32))
        if point_coords is not None:
            pts.append(np.asarray(point_coords, np.float32) * scale)
            labels.append(np.asarray(point_labels, np.int32))
        outs = self.core.sam_heads(
            self._feat, self._high_res, np.concatenate(pts, 0)[None],
            np.concatenate(labels, 0)[None], multimask=multimask_output)
        high_multi, ious = outs[1], outs[2]
        masks = resize_linear(high_multi, H0, W0)
        return ((masks[0] > 0.0).cpu().numpy(), ious[0].cpu().numpy(),
                high_multi[0].cpu().numpy())


class SAM2VideoPredictor:
    """Single-object video propagation (sam2_video_predictor.py subset)."""

    def __init__(self, model: SAM2, device="cuda"):
        self.core = _Core(model, device)
        self.cfg = model.cfg

    def init_state(self, video_path: Optional[str] = None,
                   frames: Optional[List[np.ndarray]] = None) -> dict:
        """Frames from a directory of PNG files (sorted by name; any other
        file raises) or a list of (H, W, 3) arrays; features are encoded
        lazily, one frame at a time."""
        if frames is None:
            files = sorted(os.listdir(video_path))
            other = [f for f in files if not f.lower().endswith(".png")]
            if other:
                raise ValueError(f"{video_path}: only PNG frames are read, "
                                 f"found {other[:3]}")
            frames = [read_frame(os.path.join(video_path, f)) for f in files]
        return {
            "frames": frames,
            "orig_hw": frames[0].shape[:2],
            "num_frames": len(frames),
            "features": {},             # frame -> (high_res, feat, pos)
            "cond_outputs": {},         # frame -> output dict
            "non_cond_outputs": {},
        }

    def _features(self, state, frame_idx):
        if frame_idx not in state["features"]:
            out = self.core.encode(state["frames"][frame_idx])
            feats = out["backbone_fpn"]
            state["features"][frame_idx] = (
                [feats[0], feats[1]], feats[2], out["vision_pos_enc"][2])
        return state["features"][frame_idx]

    def add_new_points_or_box(self, state, frame_idx: int, obj_id: int = 0,
                              points=None, labels=None, box=None,
                              normalize_coords: bool = True):
        """Prompt the conditioning frame; returns (frame_idx, [obj_id], the
        low-res mask logits resized to the video's size as numpy)."""
        H0, W0 = state["orig_hw"]
        pts_list, lab_list = [], []
        if box is not None:
            pts_list.append(np.asarray(box, np.float32).reshape(2, 2))
            lab_list.append(np.array([2, 3], np.int32))
        if points is not None:
            pts_list.append(np.asarray(points, np.float32))
            lab_list.append(np.asarray(labels, np.int32))
        pts = np.concatenate(pts_list, 0)
        labs = np.concatenate(lab_list, 0)
        if normalize_coords:
            pts = pts / np.array([W0, H0], np.float32)
            pts = pts * self.cfg.image_size

        high_res, feat, pos = self._features(state, frame_idx)
        pix = self.core.first_frame_feat(feat)
        multimask = 0 <= labs.shape[0] <= 1                  # _use_multimask
        outs = self.core.sam_heads(pix, high_res, pts[None], labs[None],
                                   multimask=multimask)
        low_res, high_res_masks, obj_ptr = outs[3], outs[4], outs[5]
        mem_feat, mem_pos = self.core.encode_memory(feat, high_res_masks)
        state["cond_outputs"][frame_idx] = {
            "maskmem_features": mem_feat, "maskmem_pos_enc": mem_pos,
            "obj_ptr": obj_ptr, "pred_masks": low_res,
        }
        return (frame_idx, [obj_id],
                resize_linear(low_res, H0, W0).cpu().numpy())

    def add_new_mask(self, state, frame_idx: int, obj_id: int, mask):
        """A binary mask as the conditioning frame's output
        (use_mask_input_as_output_without_sam, sam2_base.py:739-748)."""
        S = self.cfg.image_size
        m = self.core.tensor(np.asarray(mask, np.float32))
        m = resize_nearest(m[None, None], S, S).permute(0, 2, 3, 1)
        high_res, feat, pos = self._features(state, frame_idx)
        pix = self.core.first_frame_feat(feat)
        with torch.no_grad(), precision_scope():
            low_res, high_masks, obj_ptr, _ = use_mask_as_output(
                self.core.model, pix, high_res, m.to(pix.dtype))
        mem_feat, mem_pos = self.core.encode_memory(feat, high_masks)
        state["cond_outputs"][frame_idx] = {
            "maskmem_features": mem_feat, "maskmem_pos_enc": mem_pos,
            "obj_ptr": obj_ptr, "pred_masks": low_res,
        }
        return frame_idx, [obj_id], low_res.cpu().numpy()

    def _select_memories(self, state, frame_idx):
        """Memory frame selection (sam2_base.py:514-561, stride 1, forward
        in time)."""
        cfg = self.cfg
        tpos = self.core.model.maskmem_tpos_enc.detach()
        mems = [(0, out) for _, out in sorted(state["cond_outputs"].items())]
        for t_pos in range(1, cfg.num_maskmem):
            out = state["non_cond_outputs"].get(
                frame_idx - (cfg.num_maskmem - t_pos))
            if out is not None:
                mems.append((t_pos, out))
        feats = [out["maskmem_features"] for _, out in mems]
        posenc = [out["maskmem_pos_enc"][None]
                  + tpos[cfg.num_maskmem - t_pos - 1] for t_pos, out in mems]
        memories = torch.stack(feats, dim=1)              # (1, T, h, w, m)
        memory_pos = torch.stack(posenc, dim=1)

        # Object pointers: past conditioning frames, then recent others.
        ptrs = [out["obj_ptr"] for t, out in state["cond_outputs"].items()
                if t <= frame_idx]
        max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
        for t_diff in range(1, max_ptrs):
            t = frame_idx - t_diff
            if t < 0:
                break
            out = state["non_cond_outputs"].get(t)
            if out is not None:
                ptrs.append(out["obj_ptr"])
        return memories, memory_pos, torch.stack(ptrs, dim=1)

    def _track_frame(self, state, frame_idx):
        high_res, feat, pos = self._features(state, frame_idx)
        memories, memory_pos, obj_ptrs = self._select_memories(state,
                                                               frame_idx)
        pix = self.core.conditioned_feat(feat, pos, memories, memory_pos,
                                         obj_ptrs)
        outs = self.core.sam_heads(pix, high_res, multimask=True)
        low_res, high_masks, obj_ptr = outs[3], outs[4], outs[5]
        mem_feat, mem_pos = self.core.encode_memory(feat, high_masks)
        state["non_cond_outputs"][frame_idx] = {
            "maskmem_features": mem_feat, "maskmem_pos_enc": mem_pos,
            "obj_ptr": obj_ptr,
        }
        return low_res

    def propagate_in_video(self, state, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False):
        """Yields (frame_idx, [obj_id], mask logits (1, 1, H0, W0) numpy)."""
        H0, W0 = state["orig_hw"]
        cond_frames = sorted(state["cond_outputs"])
        start = (start_frame_idx if start_frame_idx is not None
                 else cond_frames[0])
        end = (state["num_frames"] if max_frame_num_to_track is None
               else min(state["num_frames"], start + max_frame_num_to_track))
        for frame_idx in range(start, end):
            if frame_idx in state["cond_outputs"]:
                low_res = state["cond_outputs"][frame_idx]["pred_masks"]
            else:
                low_res = self._track_frame(state, frame_idx)
            yield frame_idx, [0], resize_linear(low_res, H0, W0).cpu().numpy()

    def reset_state(self, state) -> None:
        state["cond_outputs"].clear()
        state["non_cond_outputs"].clear()
