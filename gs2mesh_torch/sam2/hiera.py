"""Hiera trunk + FPN neck (the SAM2 image encoder), the port of gs2mesh_tpu
sam2/hiera.py (sam2/modeling/backbones/{hieradet,image_encoder}.py):
windowed multi-scale attention blocks with q-pooling stage transitions, the
windowed positional embedding, and the FPN neck emitting /4, /8, /16 (the
caller drops /32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import (MLP, Named, Norm, conv2d, gelu_tanh,
                                       interpolate_nearest_2x, layer_norm,
                                       linear, mlp, sdpa, sine_pos_embed_2d,
                                       window_partition, window_unpartition)


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (1, 2, 7, 2)
    global_att_blocks: Tuple[int, ...] = (5, 7, 9)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    q_pool: int = 3

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self):
        return [sum(self.stages[:i]) - 1
                for i in range(1, len(self.stages) + 1)]

    @property
    def q_pool_blocks(self):
        return [x + 1 for x in self.stage_ends[:-1]][: self.q_pool]

    def block_spec(self, i: int):
        """(dim, dim_out, num_heads, window_size, has_pool) of block i, the
        constructor loop of hieradet.py:229-257."""
        embed_dim, num_heads, cur_stage = self.embed_dim, self.num_heads, 1
        for j in range(i + 1):
            dim = embed_dim
            window_size = self.window_spec[cur_stage - 1]
            if j in self.global_att_blocks:
                window_size = 0
            if j - 1 in self.stage_ends:
                dim_out = int(embed_dim * self.dim_mul)
                num_heads = int(num_heads * self.head_mul)
                cur_stage += 1
            else:
                dim_out = embed_dim
            embed_dim = dim_out
        return dim, dim_out, num_heads, window_size, i in self.q_pool_blocks

    @property
    def channel_list(self):
        """Per-stage output dims, low resolution first
        (hieradet.py:259-263)."""
        return [self.block_spec(end)[1] for end in self.stage_ends][::-1]


# ------------------------------------------------------------------ modules

class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.norm1 = Norm(dim)
        self.attn = MultiScaleAttention(dim, dim_out)
        self.norm2 = Norm(dim_out)
        self.mlp = MLP([dim_out, 4 * dim_out, dim_out])
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)


class Hiera(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        hb, wb = cfg.window_pos_embed_bkg_spatial_size
        ws = cfg.window_spec[0]
        self.patch_embed = Named(proj=nn.Conv2d(3, cfg.embed_dim, 7, 4, 3))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, hb, wb))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, ws, ws))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(*cfg.block_spec(i)[:2]) for i in range(cfg.depth))


class FpnNeck(nn.Module):
    def __init__(self, backbone_channel_list, d_model: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(Named(conv=nn.Conv2d(c, d_model, 1))
                                   for c in backbone_channel_list)


class ImageEncoder(nn.Module):
    def __init__(self, hiera: HieraConfig, backbone_channel_list):
        super().__init__()
        self.trunk = Hiera(hiera)
        self.neck = FpnNeck(backbone_channel_list)


# ------------------------------------------------------------------ forward

def _maxpool2x2(x):
    """nn.MaxPool2d(2, 2) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def multiscale_attention(x, m: MultiScaleAttention, num_heads: int,
                         q_pool: bool):
    """MultiScaleAttention (hieradet.py:37-79). x: (B, H, W, C)."""
    B, H, W, _ = x.shape
    qkv = linear(x.reshape(B, H * W, -1), m.qkv).reshape(B, H * W, 3,
                                                         num_heads, -1)
    q, k, v = qkv.unbind(2)
    if q_pool:
        q = _maxpool2x2(q.reshape(B, H, W, -1))
        H, W = q.shape[1:3]
        q = q.reshape(B, H * W, num_heads, -1)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return linear(out.transpose(1, 2).reshape(B, H, W, -1), m.proj)


def multiscale_block(x, m: MultiScaleBlock, dim: int, dim_out: int,
                     num_heads: int, window_size: int, has_pool: bool):
    """MultiScaleBlock (hieradet.py:82-164); LayerNorm eps 1e-6 and the
    tanh GELU of the JAX package."""
    shortcut = x
    x = layer_norm(x, m.norm1, eps=1e-6)
    if dim != dim_out:
        shortcut = linear(x, m.proj)
        if has_pool:
            shortcut = _maxpool2x2(shortcut)

    ws = window_size
    H, W = x.shape[1], x.shape[2]
    if ws > 0:
        x, pad_hw = window_partition(x, ws)
    x = multiscale_attention(x, m.attn, num_heads, has_pool)
    if has_pool:
        ws = window_size // 2
        H, W = shortcut.shape[1:3]
        pad_h = (ws - H % ws) % ws if ws > 0 else 0
        pad_w = (ws - W % ws) % ws if ws > 0 else 0
        pad_hw = (H + pad_h, W + pad_w)
    if window_size > 0:
        x = window_unpartition(x, ws, pad_hw, (H, W))

    x = shortcut + x
    return x + mlp(layer_norm(x, m.norm2, eps=1e-6), m.mlp,
                   activation=gelu_tanh)


def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix of torch F.interpolate
    mode='bicubic', align_corners=False (A=-0.75, replicated border)."""
    A = -0.75

    def cubic(t):
        t = abs(t)
        if t <= 1:
            return (A + 2) * t ** 3 - (A + 3) * t ** 2 + 1
        if t < 2:
            return A * t ** 3 - 5 * A * t ** 2 + 8 * A * t - 4 * A
        return 0.0

    M = np.zeros((dst, src), np.float64)
    scale = src / dst
    for d in range(dst):
        s = (d + 0.5) * scale - 0.5
        s0 = math.floor(s)
        for i in range(-1, 3):
            idx = min(max(s0 + i, 0), src - 1)
            M[d, idx] += cubic(s - (s0 + i))
    return M.astype(np.float32)


def hiera_pos_embed(m: Hiera, h: int, w: int):
    """_get_pos_embed (hieradet.py:265-273): the bicubic background embed
    plus the tiled window embed, as (1, h, w, C)."""
    bg, win = m.pos_embed, m.pos_embed_window
    _, C, hb, wb = bg.shape
    My = torch.from_numpy(bicubic_matrix(hb, h)).to(bg)
    Mx = torch.from_numpy(bicubic_matrix(wb, w)).to(bg)
    up = torch.einsum("yh,bchw,xw->bcyx", My, bg, Mx)
    ws = win.shape[-1]
    tiled = win.repeat(1, 1, h // ws, w // ws)
    return (up + tiled).permute(0, 2, 3, 1)


def hiera_forward(x, m: Hiera) -> List[torch.Tensor]:
    """x: (B, H, W, 3) normalized image -> per-stage NHWC features, high
    resolution first: [/4, /8, /16, /32]."""
    cfg = m.cfg
    x = conv2d(x, m.patch_embed.proj)
    x = x + hiera_pos_embed(m, x.shape[1], x.shape[2])
    outputs = []
    for i, block in enumerate(m.blocks):
        x = multiscale_block(x, block, *cfg.block_spec(i))
        if i in cfg.stage_ends:
            outputs.append(x)
    return outputs


def fpn_neck_forward(xs, m: FpnNeck, fpn_top_down_levels=(2, 3),
                     pos_feats: int = 256):
    """FpnNeck (image_encoder.py:44-130) with the nearest top-down path.
    xs: high-res-first trunk outputs. Returns (features, pos), high-res
    first."""
    n = len(xs) - 1
    out = [None] * len(xs)
    pos = [None] * len(xs)
    prev = None
    for i in range(n, -1, -1):
        lateral = conv2d(xs[i], m.convs[n - i].conv)
        if i in fpn_top_down_levels and prev is not None:
            prev = lateral + interpolate_nearest_2x(prev)
        else:
            prev = lateral
        out[i] = prev
        h, w = prev.shape[1:3]
        pos[i] = sine_pos_embed_2d(h, w, pos_feats, prev)[None].expand(
            prev.shape[0], h, w, pos_feats)
    return out, pos
