"""DLNR: extractor -> correlation pyramid -> iterative conv-LSTM updates ->
convex upsampling (-> refinement when the disparity is all negative).

The port's copy of gs2mesh_tpu stereo/dlnr.py (DLNR core/dlnr.py:24-133)
in the gs2mesh inference configuration (stereo_utils.py:44-55: corr 'reg',
4 levels, radius 4, 3 LSTM levels, hidden 128, n_downsample 2, 10
iterations). Images are (B, 3, H, W) floats in [0, 255] with H and W
multiples of 32 (stereo.InputPadder). Each stage of the forward runs in a
``record_function`` range named in FORWARD_STAGES.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from gs2mesh_torch.core.precision import precision_scope
from gs2mesh_torch.stereo.corr import build_corr_pyramid, lookup_corr
from gs2mesh_torch.stereo.extractor import Extractor, extractor_forward
from gs2mesh_torch.stereo.layers import (Attention, LayerNorm, ResidualBlock,
                                         conv2d, residual_block_instance)
from gs2mesh_torch.stereo.refinement import Refinement, refinement_forward
from gs2mesh_torch.stereo.update import UpdateBlock, update_block

FORWARD_STAGES = ("extractor", "volume", "context", "corr_pyramid", "lookup",
                  "update", "upsample", "refinement")


@dataclasses.dataclass(frozen=True)
class DLNRConfig:
    iters: int = 10                # valid_iters (stereo_utils.py:55)
    corr_levels: int = 4
    corr_radius: int = 4
    hidden: int = 128
    factor: int = 4                # 2 ** n_downsample


class DLNR(nn.Module):
    """The weights, named as the reference's state dict names them; the
    forward is ``dlnr_forward``. ``last_refined`` says whether the latest
    forward ran the refinement."""

    def __init__(self, hidden=128):
        super().__init__()
        self.extractor = Extractor()
        self.update_block = UpdateBlock(hidden)
        self.bias_convs = nn.ModuleList(
            nn.Conv2d(hidden, 4 * hidden, 3, padding=1) for _ in range(3))
        self.volume_conv = nn.Sequential(ResidualBlock(128),
                                         nn.Conv2d(128, 256, 3, padding=1))
        self.normalizationRefinement = Refinement()
        self.last_refined = None


def upsample_flow(flow, mask, factor=4):
    """Convex upsampling (core/dlnr.py:55-66). flow: (B, D, H, W); mask:
    (B, 9·factor², H, W) with channel c = k·factor² + i·factor + j."""
    b, d, h, w = flow.shape
    m = mask.reshape(b, 1, 9, factor, factor, h, w).softmax(dim=2)
    nb = F.unfold(factor * flow, [3, 3], padding=1)          # (B, D·9, H·W)
    nb = nb.reshape(b, d, 9, 1, 1, h, w)
    up = (m * nb).sum(dim=2)                                 # (B,D,f,f,H,W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, d, factor * h, factor * w)


def dlnr_forward(model: DLNR, image1, image2, cfg: DLNRConfig = DLNRConfig(),
                 flow_init=None):
    """image1 / image2: (B, 3, H, W) in [0, 255]. Returns (flow_low,
    disp_full) as the reference's test_mode=True does: flow_low (B, 2, H/4,
    W/4) to warm-start the next view, disp_full (B, 1, H, W) (negative
    disparities). Convs and matmuls run in float32 with TF32 off unless a
    layers.matmul_dtype block says otherwise."""
    with precision_scope():
        x1 = image1 / 255.0 * 2.0 - 1.0
        x2 = image2 / 255.0 * 2.0 - 1.0
        b, _, h, w = x1.shape
        h4, w4 = h // cfg.factor, w // cfg.factor

        with record_function("dlnr.extractor"):
            outputs04, outputs08, outputs16, v = extractor_forward(
                torch.cat([x1, x2]), model.extractor)
        with record_function("dlnr.volume"):
            vc = residual_block_instance(v, model.volume_conv[0])
            vc = conv2d(vc, model.volume_conv[1])            # 256
            fmap1, fmap2 = vc[:b], vc[b:]
        with record_function("dlnr.context"):
            cnet = [outputs04, outputs08, outputs16]
            net_h = [torch.tanh(o[0]) for o in cnet]
            net_ext = [conv2d(F.relu(o[1]), model.bias_convs[i]).chunk(4, 1)
                       for i, o in enumerate(cnet)]
        with record_function("dlnr.corr_pyramid"):
            pyramid = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels)

        flow_x = x1.new_zeros((b, h4, w4))
        if flow_init is not None:
            flow_x = flow_x + flow_init[:, 0]
        coords0 = torch.arange(w4, dtype=x1.dtype, device=x1.device)
        netH = net_h
        up_mask = x1.new_zeros((b, 9 * cfg.factor ** 2, h4, w4))
        for _ in range(cfg.iters):
            with record_function("dlnr.lookup"):
                corr = lookup_corr(pyramid, flow_x + coords0, cfg.corr_radius)
            with record_function("dlnr.update"):
                flow = torch.stack([flow_x, torch.zeros_like(flow_x)], dim=1)
                # Reference quirk, kept: dlnr.py:100-105 binds netC = net_h
                # (the SAME list), and the in-place tuple writes in
                # LSTMMultiUpdateBlock make the hidden-state store overwrite
                # the cell-state store, so the LSTM's cell input is always
                # the previous HIDDEN state. The released checkpoints were
                # trained with it.
                _, netH, up_mask, delta = update_block(
                    netH, netH, net_ext, corr, flow, model.update_block)
                flow_x = flow_x + delta[:, 0]                # y pinned to 0

        with record_function("dlnr.upsample"):
            flow = torch.stack([flow_x, torch.zeros_like(flow_x)], dim=1)
            disp_full = upsample_flow(flow, up_mask, cfg.factor)[:, :1]
            # The gate tests the WHOLE batch (core/dlnr.py:120-126), so the
            # [LR, RL] rows of the stage are not independent here; reading
            # it is a device-to-host sync.
            refined = bool(disp_full.max() < 0)
        if refined:
            with record_function("dlnr.refinement"):
                disp_full = refinement_forward(disp_full, x1, x2,
                                               model.normalizationRefinement)
        model.last_refined = refined
        return flow, disp_full


def init_dlnr_(model: DLNR, generator: torch.Generator) -> DLNR:
    """Seeded weights with the distributions of the JAX package's ParamMaker
    (stereo/layers.py:282-340): He-normal conv weights (fan-in over the
    kernel and the input channels of a group), zero biases, identity batch
    norms and layer norms, unit attention temperature. In place; returns
    the model."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                wt = m.weight
                fan_in = (wt.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else wt.shape[1]) * wt.shape[2] * wt.shape[3]
                wt.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, LayerNorm):
                m.body.weight.fill_(1.0)
                m.body.bias.zero_()
            elif isinstance(m, Attention):
                m.temperature.fill_(1.0)
    return model
