"""Edge padding to a multiple of ``divis_by``: the port's copy of
gs2mesh_tpu stereo/padder.py (DLNR's InputPadder, core/utils/utils.py:7-27,
used with divis_by=32 by the stereo stage), for numpy arrays and tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (B, C, H, W) arrays or tensors so H and W divide by
    ``divis_by``, the padding split evenly top / bottom and left / right
    (the reference's 'sintel' mode, the one the stereo stage uses)."""

    def __init__(self, dims, divis_by=8):
        ht, wd = dims[-2:]
        pad_ht = (((ht // divis_by) + 1) * divis_by - ht) % divis_by
        pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, *inputs):
        l, r, t, b = self._pad
        return [F.pad(x, self._pad, mode="replicate")
                if isinstance(x, torch.Tensor) else
                np.pad(x, ((0, 0), (0, 0), (t, b), (l, r)), mode="edge")
                for x in inputs]

    def unpad(self, x):
        ht, wd = x.shape[-2:]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r]
