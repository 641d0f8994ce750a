"""Coarse-to-fine conv-LSTM update block.

The port's copy of gs2mesh_tpu stereo/update.py (DLNR's
LSTMMultiUpdateBlock, core/update.py:173-212): the BasicMotionEncoder
(:87-108), conv-LSTM cells with external per-gate context biases, the flow
head and the convex-upsampling mask head. Level order: net[0] at 1/4
(finest), net[1] at 1/8, net[2] at 1/16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.stereo.layers import avg_pool_2x, conv2d, interp_bilinear


class MotionEncoder(nn.Module):
    def __init__(self, corr_planes=4 * 9):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 126, 3, padding=1)


def motion_encoder(flow, corr, p: MotionEncoder):
    """flow: (B, 2, H, W); corr: (B, 36, H, W). Returns (B, 128, H, W)."""
    cor = F.relu(conv2d(F.relu(conv2d(corr, p.convc1)), p.convc2))
    flo = F.relu(conv2d(F.relu(conv2d(flow, p.convf1)), p.convf2))
    out = F.relu(conv2d(torch.cat([cor, flo], dim=1), p.conv))
    return torch.cat([out, flow], dim=1)


class LSTMCell(nn.Module):
    def __init__(self, hidden, inp):
        super().__init__()
        for name in ("conv_it", "conv_c_t", "conv_ft", "conv_ot"):
            setattr(self, name, nn.Conv2d(hidden + inp, hidden, 3, padding=1))


def lstm_cell(c, h, biases, xs, p: LSTMCell):
    """Conv-LSTM with external per-gate biases (update.py:37-54); biases =
    (bi, bf, bc, bo) from the bias_convs context injection."""
    bi, bf, bc, bo = biases
    hx = torch.cat([h, *xs], dim=1)
    ft = torch.sigmoid(conv2d(hx, p.conv_ft) + bf)
    it = torch.sigmoid(conv2d(hx, p.conv_it) + bi)
    c_t = torch.tanh(conv2d(hx, p.conv_c_t) + bc)
    ct = c * ft + it * c_t
    ot = torch.sigmoid(conv2d(hx, p.conv_ot) + bo)
    return ct, ot * torch.tanh(ct)


class UpdateBlock(nn.Module):
    def __init__(self, hidden=128, corr_planes=4 * 9):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.lstm08 = LSTMCell(hidden, 128 + hidden)
        self.lstm16 = LSTMCell(hidden, 2 * hidden)
        self.lstm32 = LSTMCell(hidden, hidden)
        self.flow_head = nn.Module()
        self.flow_head.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.flow_head.conv2 = nn.Conv2d(256, 2, 3, padding=1)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 16 * 9, 1))


def update_block(netC, netH, net_ext, corr, flow, p: UpdateBlock):
    """One LSTMMultiUpdateBlock step with 3 levels. netC / netH: [c / h at
    1/4, 1/8, 1/16]; net_ext: per-level 4-tuples of gate biases. Returns
    (netC, netH, up_mask, delta_flow)."""
    netC, netH = list(netC), list(netH)
    # Coarsest (1/16): input = pooled 1/8 hidden state.
    netC[2], netH[2] = lstm_cell(netC[2], netH[2], net_ext[2],
                                 [avg_pool_2x(netH[1])], p.lstm32)
    # Middle (1/8): pooled 1/4 hidden + upsampled 1/16 hidden.
    up2 = interp_bilinear(netH[2], *netH[1].shape[-2:])
    netC[1], netH[1] = lstm_cell(netC[1], netH[1], net_ext[1],
                                 [avg_pool_2x(netH[0]), up2], p.lstm16)
    # Finest (1/4): motion features + upsampled 1/8 hidden.
    motion = motion_encoder(flow, corr, p.encoder)
    up1 = interp_bilinear(netH[1], *netH[0].shape[-2:])
    netC[0], netH[0] = lstm_cell(netC[0], netH[0], net_ext[0],
                                 [motion, up1], p.lstm08)

    delta = conv2d(F.relu(conv2d(netH[0], p.flow_head.conv1)),
                   p.flow_head.conv2)
    mask = conv2d(F.relu(conv2d(netH[0], p.mask[0])), p.mask[2]) * 0.25
    return netC, netH, mask, delta
