"""Swin Transformer backbone (the GroundingDINO variant), the port of
gs2mesh_tpu gdino/swin.py (backbone/swin_transformer.py): windowed attention
with a relative position bias, shifted windows with the cyclic-shift
attention mask, patch merging, per-out-index LayerNorms. Swin-T: embed 96,
depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7, out_indices (1, 2, 3).

Token-major (B, H*W, C) activations; the feature maps come out NHWC.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import Named, Norm, conv2d, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)

    @property
    def num_channels(self):
        return [int(self.embed_dim * 2 ** i) for i in self.out_indices]


# ------------------------------------------------------------------ modules

class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int, mlp_ratio: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = Norm(dim)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = Norm(dim)
        self.mlp = Named(fc1=nn.Linear(dim, hidden),
                         fc2=nn.Linear(hidden, dim))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = Norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, ws: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, num_heads, ws, mlp_ratio)
                                    for _ in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Every Swin weight under the released ``backbone.0.`` names
    (the reference's ``relative_position_index`` buffers are recomputed)."""

    def __init__(self, cfg: SwinConfig = SwinConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = Named(proj=nn.Conv2d(3, cfg.embed_dim, 4, 4),
                                 norm=Norm(cfg.embed_dim))
        self.layers = nn.ModuleList(
            BasicLayer(int(cfg.embed_dim * 2 ** i), depth, cfg.num_heads[i],
                       cfg.window_size, cfg.mlp_ratio,
                       i < len(cfg.depths) - 1)
            for i, depth in enumerate(cfg.depths))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", Norm(int(cfg.embed_dim * 2 ** i)))


# ---------------------------------------------------------------- forward

def _window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(w, ws, H, W):
    B = w.shape[0] // (H * W // ws // ws)
    x = w.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))           # 2, ws, ws
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]                # 2, n, n
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)                                       # n, n


@functools.lru_cache(maxsize=8)
def _rel_pos_index_t(ws: int, device) -> torch.Tensor:
    return torch.from_numpy(_rel_pos_index(ws).reshape(-1)).to(device)


def window_attention(x, m: WindowAttention, num_heads: int, ws: int,
                     attn_mask=None):
    """WindowAttention (swin_transformer.py:77-175). x: (nW*B, n, C);
    attn_mask: (nW, n, n) additive."""
    Bn, n, C = x.shape
    qkv = linear(x, m.qkv).reshape(Bn, n, 3, num_heads, C // num_heads)
    q = qkv[:, :, 0].transpose(1, 2) * (C // num_heads) ** -0.5
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)

    attn = torch.matmul(q, k.transpose(-1, -2))
    idx = _rel_pos_index_t(ws, x.device)
    bias = m.relative_position_bias_table[idx].reshape(
        n, n, num_heads).permute(2, 0, 1)
    attn = attn + bias[None]
    if attn_mask is not None:
        nW = attn_mask.shape[0]
        attn = attn.reshape(Bn // nW, nW, num_heads, n, n) \
            + attn_mask[None, :, None]
        attn = attn.reshape(Bn, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(Bn, n, C)
    return linear(out, m.proj)


def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask (swin_transformer.py:417-446): (nW, n, n)
    float32, -100 between windows' regions of different origin."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for h in slices:
        for w in slices:
            img[h, w] = cnt
            cnt += 1
    mw = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _shift_mask_t(Hp, Wp, ws, shift, device, dtype):
    return torch.from_numpy(shift_attn_mask(Hp, Wp, ws, shift)).to(
        device, dtype)


def swin_block(x, m: SwinBlock, H: int, W: int, num_heads: int, ws: int,
               shift: int):
    """SwinTransformerBlock (swin_transformer.py:177-298). x: (B, H*W, C)."""
    B, L, C = x.shape
    shortcut = x
    x = layer_norm(x, m.norm1).reshape(B, H, W, C)

    pad_r = (ws - W % ws) % ws
    pad_b = (ws - H % ws) % ws
    if pad_r or pad_b:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r

    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        attn_mask = _shift_mask_t(Hp, Wp, ws, shift, x.device, x.dtype)
    else:
        attn_mask = None

    xw = _window_partition(x, ws)
    xw = window_attention(xw, m.attn, num_heads, ws, attn_mask)
    x = _window_reverse(xw, ws, Hp, Wp)

    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    if pad_r or pad_b:
        x = x[:, :H, :W]
    x = shortcut + x.reshape(B, H * W, C)
    h = layer_norm(x, m.norm2)
    h = linear(F.gelu(linear(h, m.mlp.fc1)), m.mlp.fc2)       # exact GELU
    return x + h


def patch_merging(x, m: PatchMerging, H: int, W: int):
    """PatchMerging (swin_transformer.py:301-340)."""
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    x = torch.cat([x0, x1, x2, x3], dim=-1).reshape(B, -1, 4 * C)
    return linear(layer_norm(x, m.norm), m.reduction)


def swin_forward(img, m: SwinTransformer):
    """img: (B, H, W, 3) normalised NHWC. Returns the NHWC feature maps at
    out_indices, each after its LayerNorm."""
    cfg = m.cfg
    x = conv2d(img, m.patch_embed.proj)
    B, Wh, Ww, C = x.shape
    x = layer_norm(x.reshape(B, Wh * Ww, C), m.patch_embed.norm)

    outs = []
    H, W = Wh, Ww
    for i, layer in enumerate(m.layers):
        for b, block in enumerate(layer.blocks):
            shift = 0 if b % 2 == 0 else cfg.window_size // 2
            x = swin_block(x, block, H, W, cfg.num_heads[i],
                           cfg.window_size, shift)
        if i in cfg.out_indices:
            y = layer_norm(x, getattr(m, f"norm{i}"))
            outs.append(y.reshape(B, H, W, -1))
        if layer.downsample is not None:
            x = patch_merging(x, layer.downsample, H, W)
            H, W = (H + 1) // 2, (W + 1) // 2
    return outs
