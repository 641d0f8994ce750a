"""Normalization refinement hourglass.

The port's copy of gs2mesh_tpu stereo/refinement.py (DLNR's
NormalizationRefinement, nets/refinement.py:18-116): the photometric error of
the disparity-warped right image, the left image and the width-normalised
disparity through a GANet-style hourglass (plain convs: the reference's
mdconv flag is dead code), emitting a residual disparity. DLNR applies it
only when the disparity is negative everywhere in the batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.stereo.layers import (BasicConv, Conv2x, basic_conv,
                                         batch_norm_eval, conv2d, conv2x)


def disp_warp(img, disp):
    """Warp the right image to the left view by positive disparity, as the
    reference does (nets/warp.py:41-64): it normalises the grid by the
    align_corners=True convention but runs grid_sample with
    align_corners=False and border padding, so the sample point is
    (x·W/(W-1) - 0.5, y·H/(H-1) - 0.5), a small vertical resample included.
    That sample point is computed here directly, as the JAX package does
    (rounding the normalised grid through grid_sample would move it by up
    to 1e-5 pixels), and sampled bilinearly with edge clamping.

    img: (B, C, H, W); disp: (B, 1, H, W)."""
    b, c, h, w = img.shape
    ys = torch.arange(h, dtype=img.dtype, device=img.device) * (h / (h - 1)) \
        - 0.5
    y0f = torch.floor(ys)
    ty = (ys - y0f)[:, None]
    y0 = y0f.long().clamp(0, h - 1)
    y1 = (y0f.long() + 1).clamp(0, h - 1)

    xs = torch.arange(w, dtype=img.dtype, device=img.device)
    xg = (xs - disp) * (w / (w - 1)) - 0.5                   # (B, 1, H, W)
    x0f = torch.floor(xg)
    tx = xg - x0f
    x0 = x0f.long().clamp(0, w - 1).expand(b, c, h, w)
    x1 = (x0f.long() + 1).clamp(0, w - 1).expand(b, c, h, w)

    def lerp_x(rows):
        return (torch.gather(rows, 3, x0) * (1.0 - tx)
                + torch.gather(rows, 3, x1) * tx)

    return lerp_x(img[:, :, y0]) * (1.0 - ty) + lerp_x(img[:, :, y1]) * ty


class Refinement(nn.Module):
    def __init__(self):
        super().__init__()

        def conv_bn_lrelu(cin, cout):
            return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1,
                                           bias=False),
                                 nn.BatchNorm2d(cout), nn.LeakyReLU(0.2))

        self.conv1 = conv_bn_lrelu(6, 16)
        self.conv2 = conv_bn_lrelu(1, 16)
        self.conv_start = BasicConv(32, 32, padding=2, dilation=2)
        self.conv1a = BasicConv(32, 48, stride=2)
        self.conv2a = BasicConv(48, 64, stride=2)
        self.conv3a = BasicConv(64, 96, stride=2, padding=2, dilation=2)
        self.conv4a = BasicConv(96, 128, stride=2, padding=2, dilation=2)
        for name, cin, cout, deconv in (
                ("deconv4a", 128, 96, True), ("deconv3a", 96, 64, True),
                ("deconv2a", 64, 48, True), ("deconv1a", 48, 32, True),
                ("conv1b", 32, 48, False), ("conv2b", 48, 64, False),
                ("conv3b", 64, 96, False), ("conv4b", 96, 128, False),
                ("deconv4b", 128, 96, True), ("deconv3b", 96, 64, True),
                ("deconv2b", 64, 48, True), ("deconv1b", 48, 32, True)):
            setattr(self, name, Conv2x(cin, cout, deconv=deconv))
        self.final_conv = nn.Conv2d(32, 1, 3, padding=1)


def _conv_bn_lrelu(x, p: nn.Sequential):
    return F.leaky_relu(batch_norm_eval(conv2d(x, p[0]), p[1]), 0.2)


def refinement_forward(low_disp, left, right, p: Refinement):
    """low_disp: (B, 1, H, W) full-resolution NEGATIVE disparity; left /
    right: (B, 3, H, W) in [-1, 1]. Returns the refined (still negative)
    disparity."""
    w = low_disp.shape[-1]
    disp = -low_disp                                         # positive
    warped = disp_warp(right, disp)
    disp = disp / w * 1024.0

    conv1 = _conv_bn_lrelu(torch.cat([warped - left, left], dim=1), p.conv1)
    conv2 = _conv_bn_lrelu(disp, p.conv2)
    x = basic_conv(torch.cat([conv1, conv2], dim=1), p.conv_start)  # 32
    rem0 = x
    x = rem1 = basic_conv(x, p.conv1a)
    x = rem2 = basic_conv(x, p.conv2a)
    x = rem3 = basic_conv(x, p.conv3a)
    x = rem4 = basic_conv(x, p.conv4a)

    x = rem3 = conv2x(x, rem3, p.deconv4a)
    x = rem2 = conv2x(x, rem2, p.deconv3a)
    x = rem1 = conv2x(x, rem1, p.deconv2a)
    x = rem0 = conv2x(x, rem0, p.deconv1a)

    x = rem1 = conv2x(x, rem1, p.conv1b)
    x = rem2 = conv2x(x, rem2, p.conv2b)
    x = rem3 = conv2x(x, rem3, p.conv3b)
    x = conv2x(x, rem4, p.conv4b)

    x = conv2x(x, rem3, p.deconv4b)
    x = conv2x(x, rem2, p.deconv3b)
    x = conv2x(x, rem1, p.deconv2b)
    x = conv2x(x, rem0, p.deconv1b)

    new_disp = F.leaky_relu(disp + conv2d(x, p.final_conv), 0.01)
    return -(new_disp / 1024.0 * w)
