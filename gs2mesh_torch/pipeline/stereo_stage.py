"""Stereo depth stage: DLNR over the rendered pairs, both directions in one
batch, with the occlusion mask and metric depth.

Port of gs2mesh_tpu pipeline/stereo_stage.py (the reference's
gs2mesh_utils/stereo_utils.py:25-246). Per view it renders the pair through
the renderer, reads left.png and right.png, pads them to a multiple of 32,
and runs ONE [LR, RL] DLNR forward on the model's device (the RL row is the
flip trick of stereo_utils.py:112-119: both images flipped and swapped),
warm-started from the previous view's low-resolution flows when
``stereo_warm`` is set. It applies the disparity sign, computes the LR/RL
reprojection-consistency occlusion mask (:149-179) and depth = fx·b /
disparity (:133), and writes the reference's artifacts under
NNN/out_<model>/: disparity_{LR,RL}.{npy,png}, occlusion_mask.{npy,png},
depth.{npy,png} and shading.png, with the port's own PNG writer and jet
colormap. Each part of a view runs in a ``record_function`` range named in
STAGE_RANGES; the forward's own ranges are dlnr.FORWARD_STAGES.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.colormap import jet
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.core.transforms import get_shading
from gs2mesh_torch.stereo import (DLNR, DLNRConfig, InputPadder, dlnr_forward,
                                  load_checkpoint, load_weights)

DISPARITY_SIGNS = {"DLNR_Middlebury": -1, "DLNR_SceneFlow": -1}
STAGE_RANGES = ("render_pair", "read_png", "fetch", "postprocess",
                "write_npy", "write_png")


class Stereo:
    def __init__(self, base_dir: str, renderer, args, model: DLNR = None,
                 ckpt_path: Optional[str] = None, device="cuda"):
        """model: a DLNR with its weights; if None, the torch checkpoint at
        ckpt_path (or base_dir/checkpoints/<stereo_model>.pth) is loaded on
        the first run()."""
        self.device = resolve_device(device)
        self.base_dir = base_dir
        self.renderer = renderer
        self.args = args
        self.model_name = args.stereo_model
        if self.model_name not in DISPARITY_SIGNS:
            raise ValueError(f"MODEL NOT SUPPORTED: {self.model_name}")
        self.disparity_sign = DISPARITY_SIGNS[self.model_name]
        self.cfg = DLNRConfig(iters=10)
        # Weights load LAZILY (first run()): a skip_rendering resume
        # re-enters the pipeline without them.
        self._ckpt_path = ckpt_path
        self.model = model

    def _ensure_model(self) -> DLNR:
        if self.model is None:
            self.model = load_torch_checkpoint(
                self._ckpt_path or os.path.join(
                    self.base_dir, "checkpoints", f"{self.model_name}.pth"))
        self.model = self.model.to(self.device).eval()
        return self.model

    def _forward(self, image1, image2, flow_init):
        """image*: (B, 3, H, W) float tensors in [0, 255] on the device."""
        return dlnr_forward(self.model, image1, image2, self.cfg, flow_init)

    @torch.inference_mode()
    def run(self, start: int = 0) -> None:
        """The loop over views (stereo_utils.py:82-147)."""
        self._ensure_model()
        prev_flows = {"LR": None, "RL": None}
        for camera_number, left_camera in enumerate(
                self.renderer.left_cameras):
            if camera_number < start:
                continue
            baseline = self.renderer.baseline
            output_dir = self.renderer.render_folder_name(camera_number)
            with record_function("stereo.render_pair"):
                self.renderer.render_image_pair(camera_number)

            with record_function("stereo.read_png"):
                image1 = _load_image(os.path.join(output_dir, "left.png"))
                image2 = _load_image(os.path.join(output_dir, "right.png"))
                padder = InputPadder(image1.shape, divis_by=32)
                im1, im2 = padder.pad(image1, image2)
                # Rows [LR, RL]; eval-mode batch norm and instance norm are
                # per sample, but the refinement gate is not (dlnr.py).
                b1 = np.concatenate([im1, im2[..., ::-1]], axis=0)
                b2 = np.concatenate([im2, im1[..., ::-1]], axis=0)
                warm = (self.args.stereo_warm
                        and prev_flows["LR"] is not None
                        and prev_flows["RL"] is not None)
                flow_init = (torch.from_numpy(np.concatenate(
                    [prev_flows["LR"], prev_flows["RL"]])).to(self.device)
                    if warm else None)
                b1, b2 = (torch.from_numpy(x).to(self.device)
                          for x in (b1, b2))

            prev_flow, flow_up = self._forward(b1, b2, flow_init)

            with record_function("stereo.fetch"):
                prev_flow = prev_flow.cpu().numpy()
                flow_up = flow_up.cpu().numpy()
            with record_function("stereo.postprocess"):
                disparities = {}
                for bi, direction in enumerate(("LR", "RL")):
                    pf = prev_flow[bi:bi + 1]
                    fu = flow_up[bi:bi + 1]
                    if direction == "RL":
                        pf = pf[..., ::-1]
                        fu = fu[..., ::-1]
                    prev_flows[direction] = pf
                    disparities[direction] = \
                        self.disparity_sign * padder.unpad(fu).squeeze()
                occlusion_mask = self.get_occlusion_mask(
                    disparities["LR"], disparities["RL"],
                    self.args.stereo_occlusion_threshold)
                depth = (left_camera["fx"] * baseline) / disparities["LR"]
                shading = get_shading(depth, self.args.stereo_shading_eps)

            out_sub = os.path.join(output_dir, f"out_{self.model_name}")
            os.makedirs(out_sub, exist_ok=True)
            with record_function("stereo.write_npy"):
                for direction, d in disparities.items():
                    np.save(os.path.join(out_sub,
                                         f"disparity_{direction}.npy"), d)
                np.save(os.path.join(out_sub, "occlusion_mask.npy"),
                        occlusion_mask)
                np.save(os.path.join(out_sub, "depth.npy"), depth)
            with record_function("stereo.write_png"):
                for direction, d in disparities.items():
                    _save_colormap(os.path.join(
                        out_sub, f"disparity_{direction}.png"), d)
                _save_colormap(os.path.join(out_sub, "occlusion_mask.png"),
                               occlusion_mask.astype(np.float32))
                _save_gray(os.path.join(out_sub, "depth.png"), depth)
                _save_gray(os.path.join(out_sub, "shading.png"), shading)

    @staticmethod
    def get_occlusion_mask(L2R_disparity, R2L_disparity,
                           occlusion_threshold):
        """LR<->RL reprojection consistency (stereo_utils.py:149-179): True
        where VISIBLE. Projections truncate toward zero (int32 cast)."""
        height, width = L2R_disparity.shape
        x_grid, y_grid = np.meshgrid(np.arange(width), np.arange(height))
        x_projected = (x_grid - L2R_disparity).astype(np.int32)
        x_projected_clipped = np.clip(x_projected, 0, width - 1)
        x_reprojected = x_projected_clipped + \
            R2L_disparity[y_grid, x_projected_clipped]
        x_reprojected_clipped = np.clip(x_reprojected, 0, width - 1)
        disparity_difference = np.abs(x_grid - x_reprojected_clipped)
        occluded = (disparity_difference > occlusion_threshold).astype(
            np.uint8)
        occluded[(x_projected < 0) | (x_projected >= width)] = 1
        return ~(occluded > 0.5)


def load_torch_checkpoint(path: str) -> DLNR:
    """A DLNR with the weights of a torch checkpoint (on the CPU)."""
    return load_weights(DLNR(), load_checkpoint(path))


def _load_image(path: str) -> np.ndarray:
    img = read_png(path).astype(np.float32)
    return img[None, ..., :3].transpose(0, 3, 1, 2)         # (1,3,H,W) 0..255


def _save_colormap(path: str, arr: np.ndarray) -> None:
    lo, hi = float(np.min(arr)), float(np.max(arr))
    norm = (arr - lo) / (hi - lo + 1e-12)
    write_png(path, (jet(norm) * 255).astype(np.uint8))


def _save_gray(path: str, arr: np.ndarray) -> None:
    write_png(path, np.clip(arr, 0, 255).astype(np.uint8))
