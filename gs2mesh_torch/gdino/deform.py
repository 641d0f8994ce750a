"""Multi-scale deformable attention, the port of gs2mesh_tpu gdino/deform.py.

The reference's CUDA ms_deform_attn kernel (GroundingDINO/csrc/MsDeformAttn)
became, in the JAX package, four bilinear gathers per level with
grid_sample's align_corners=False convention and zero padding. The port
keeps those four taps, their order and their in-bounds test, and gathers
each tap from the level's values flattened to (B*heads*H*W, d) with one
flat index (an index expanded to d for ``torch.gather`` would move d times
the int64 bytes).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from gs2mesh_torch.sam2.layers import linear


class MSDeformAttn(nn.Module):
    """MultiScaleDeformableAttention's weights (ms_deform_attn.py)."""

    def __init__(self, C: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4):
        super().__init__()
        self.sampling_offsets = nn.Linear(C, num_heads * num_levels
                                          * num_points * 2)
        self.attention_weights = nn.Linear(C, num_heads * num_levels
                                           * num_points)
        self.value_proj = nn.Linear(C, C)
        self.output_proj = nn.Linear(C, C)


def _bilinear_sample_zeros(value, x, y, H: int, W: int):
    """value: (Bh*H*W, d), level ``bh``'s rows at [bh*H*W, (bh+1)*H*W);
    x / y: (Bh, nq, npt) pixel coordinates (align_corners=False, zero
    padding). Returns (Bh, nq, npt, d)."""
    Bh, nq, npt = x.shape
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = (x - x0f)[..., None]
    ty = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    base = (torch.arange(Bh, device=x.device) * (H * W)).view(Bh, 1, 1)

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1) + base
        g = value.index_select(0, lin.reshape(-1)).view(Bh, nq, npt, -1)
        return torch.where(inb[..., None], g * w, 0.0)

    return (tap(x0, y0, (1 - tx) * (1 - ty))
            + tap(x0 + 1, y0, tx * (1 - ty))
            + tap(x0, y0 + 1, (1 - tx) * ty)
            + tap(x0 + 1, y0 + 1, tx * ty))


def ms_deform_attn_core(value, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations, attention_weights):
    """multi_scale_deformable_attn_pytorch. value: (B, sum(HW), heads, d);
    sampling_locations: (B, nq, heads, levels, points, 2) in [0, 1];
    attention_weights: (B, nq, heads, levels, points). Returns
    (B, nq, heads*d)."""
    B, _, heads, d = value.shape
    nq = sampling_locations.shape[1]
    npt = sampling_locations.shape[4]

    out = 0.0
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]
        start += H * W
        v = v.permute(0, 2, 1, 3).reshape(B * heads * H * W, d)
        loc = sampling_locations[:, :, :, lvl]             # (B, nq, h, p, 2)
        # grid_sample align_corners=False: pix = loc * size - 0.5
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x = x.permute(0, 2, 1, 3).reshape(B * heads, nq, npt)
        y = y.permute(0, 2, 1, 3).reshape(B * heads, nq, npt)
        sampled = _bilinear_sample_zeros(v, x, y, H, W)    # (Bh, nq, p, d)
        w = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            B * heads, nq, npt, 1)
        out = out + (sampled * w).sum(dim=2)               # (Bh, nq, d)

    out = out.reshape(B, heads, nq, d).permute(0, 2, 1, 3)
    return out.reshape(B, nq, heads * d)


@functools.lru_cache(maxsize=16)
def _normalizer(shapes, device, dtype):
    """(levels, 2) of (W, H), cached per shapes, device and dtype."""
    return torch.tensor([[w, h] for (h, w) in shapes], dtype=dtype,
                        device=device)


def ms_deform_attn(query, value_src, reference_points,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   m: MSDeformAttn, num_heads: int = 8, num_points: int = 4,
                   key_padding_mask=None):
    """MultiScaleDeformableAttention.forward (ms_deform_attn.py:260-357),
    batch-first. query / value_src: (B, n, C); reference_points: (B, nq,
    levels, 2) or (..., 4), normalised."""
    B, nq, C = query.shape
    num_levels = len(spatial_shapes)
    value = linear(value_src, m.value_proj)
    if key_padding_mask is not None:
        value = torch.where(key_padding_mask[..., None], 0.0, value)
    value = value.reshape(B, -1, num_heads, C // num_heads)

    offsets = linear(query, m.sampling_offsets).reshape(
        B, nq, num_heads, num_levels, num_points, 2)
    weights = linear(query, m.attention_weights).reshape(
        B, nq, num_heads, num_levels * num_points)
    weights = torch.softmax(weights, dim=-1).reshape(
        B, nq, num_heads, num_levels, num_points)

    if reference_points.shape[-1] == 2:
        normalizer = _normalizer(tuple(map(tuple, spatial_shapes)),
                                 query.device, query.dtype)
        loc = reference_points[:, :, None, :, None, :] \
            + offsets / normalizer[None, None, None, :, None, :]
    else:
        loc = reference_points[:, :, None, :, None, :2] \
            + offsets / num_points \
            * reference_points[:, :, None, :, None, 2:] * 0.5
    out = ms_deform_attn_core(value, spatial_shapes, loc, weights)
    return linear(out, m.output_proj)
