"""GroundingDINO's feature-enhancer encoder and cross-modality decoder, the
port of gs2mesh_tpu gdino/transformer.py (groundingdino/models/GroundingDINO/
transformer.py): encoder layers of vision-language fusion, text
self-attention and deformable image self-attention; decoder layers of query
self-attention, text cross-attention, deformable image cross-attention and
an FFN, with iterative box refinement by the one shared box head.

Tables that depend only on the feature shapes or the text positions (the
encoder's reference points, the proposals' grid, the text's sine
embedding) are made on the host in float32, as the JAX package makes them,
and moved to the activations' device and dtype: the same values on every
device.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.gdino.deform import MSDeformAttn, ms_deform_attn
from gs2mesh_torch.gdino.fusion import (MHA, BiAttentionBlock,
                                        TextEnhancerLayer, bi_attention_block,
                                        text_enhancer_layer, torch_mha)
from gs2mesh_torch.sam2.layers import MLP, Norm, layer_norm, linear, mlp

f32 = torch.float32


# ------------------------------------------------------------------ modules

class EncoderLayer(nn.Module):
    def __init__(self, C: int = 256, heads: int = 8, levels: int = 4,
                 ffn: int = 2048):
        super().__init__()
        self.self_attn = MSDeformAttn(C, heads, levels)
        self.norm1 = Norm(C)
        self.linear1 = nn.Linear(C, ffn)
        self.linear2 = nn.Linear(ffn, C)
        self.norm2 = Norm(C)


class DecoderLayer(nn.Module):
    def __init__(self, C: int = 256, heads: int = 8, levels: int = 4,
                 ffn: int = 2048):
        super().__init__()
        self.cross_attn = MSDeformAttn(C, heads, levels)
        self.norm1 = Norm(C)
        self.ca_text = MHA(C)
        self.catext_norm = Norm(C)
        self.self_attn = MHA(C)
        self.norm2 = Norm(C)
        self.linear1 = nn.Linear(C, ffn)
        self.linear2 = nn.Linear(ffn, C)
        self.norm3 = Norm(C)


class Encoder(nn.Module):
    def __init__(self, C: int, heads: int, levels: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(C, heads, levels)
                                    for _ in range(num_layers))
        self.text_layers = nn.ModuleList(TextEnhancerLayer(C)
                                         for _ in range(num_layers))
        self.fusion_layers = nn.ModuleList(BiAttentionBlock(C)
                                           for _ in range(num_layers))


class Decoder(nn.Module):
    """The decoder's own weights; its ``bbox_embed`` is the model's shared
    head (the checkpoint's ``transformer.decoder.bbox_embed`` alias)."""

    def __init__(self, C: int, heads: int, levels: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(C, heads, levels)
                                    for _ in range(num_layers))
        self.norm = Norm(C)
        self.ref_point_head = MLP([2 * C, C, C])


class Transformer(nn.Module):
    def __init__(self, C: int = 256, heads: int = 8, levels: int = 4,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 num_queries: int = 900):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(levels, C))
        self.encoder = Encoder(C, heads, levels, num_encoder_layers)
        self.decoder = Decoder(C, heads, levels, num_decoder_layers)
        self.enc_output = nn.Linear(C, C)
        self.enc_output_norm = Norm(C)
        self.enc_out_bbox_embed = MLP([C, C, C, 4])
        self.tgt_embed = nn.Embedding(num_queries, C)


# --------------------------------------------------------------- position

@functools.lru_cache(maxsize=16)
def _dim_t(num_pos_feats: int, temperature: float, device, dtype):
    """temperature ** (2 * (i // 2) / num_pos_feats), made in float32 on
    the host and cached per device and dtype (a copy to the card a call
    would wait for the work queued before it)."""
    dim_t = torch.arange(num_pos_feats, dtype=f32)
    return (temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)).to(device, dtype)


def get_sine_pos_embed(pos, num_pos_feats: int = 128,
                       temperature: float = 10000.0,
                       exchange_xy: bool = True):
    """utils.py:get_sine_pos_embed. pos: (..., n) -> (..., n*num_pos_feats)
    in pos's dtype (the frequencies are the host's float32 ones)."""
    scale = 2 * math.pi
    dim_t = _dim_t(num_pos_feats, float(temperature), pos.device, pos.dtype)

    def sine(x):
        s = x[..., None] * scale / dim_t
        return torch.stack([torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])],
                           dim=-1).reshape(*x.shape, num_pos_feats)

    parts = [sine(pos[..., i]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def gen_sineembed_for_position(pos):
    """utils.py:gen_sineembed_for_position. pos: (..., 2 or 4) in [0, 1]
    -> (..., 256 or 512) ordered (y, x[, w, h])."""
    if pos.shape[-1] == 2:
        return get_sine_pos_embed(pos, 128, exchange_xy=True)
    return torch.cat([get_sine_pos_embed(pos[..., :2], 128, exchange_xy=True),
                      get_sine_pos_embed(pos[..., 2:], 128,
                                         exchange_xy=False)], dim=-1)


def text_pos_embed(position_ids, like):
    """The text tokens' sine embedding (256 features a position), made on
    the host in float32 from ``position_ids`` (B, nt)."""
    pos = position_ids.detach().cpu().to(f32)[..., None]
    return get_sine_pos_embed(pos, num_pos_feats=256,
                              exchange_xy=False).to(like.device, like.dtype)


def inverse_sigmoid(x, eps: float = 1e-3):
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def _grid(H: int, W: int):
    """The level's cell centres ((i + 0.5) / size), (H*W, 2) as (x, y),
    float32."""
    gy = (torch.arange(H, dtype=f32) + 0.5) / H
    gx = (torch.arange(W, dtype=f32) + 0.5) / W
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)


@functools.lru_cache(maxsize=8)
def _reference_points(shapes: Tuple[Tuple[int, int], ...], device, dtype):
    ref = torch.cat([_grid(H, W) for (H, W) in shapes], dim=0)
    return ref[None, :, None, :].expand(1, ref.shape[0], len(shapes),
                                        2).to(device, dtype)


def get_reference_points(spatial_shapes: Sequence[Tuple[int, int]], like):
    """The encoder's reference points (transformer.py:465-479,
    valid_ratios 1): (1, sum HW, levels, 2). Cached per shapes, device and
    dtype: read it only."""
    return _reference_points(tuple(map(tuple, spatial_shapes)), like.device,
                             like.dtype)


@functools.lru_cache(maxsize=8)
def _proposals(shapes: Tuple[Tuple[int, int], ...], device, dtype):
    props = torch.cat([
        torch.cat([g, torch.full_like(g, 0.05 * (2.0 ** lvl))], -1)
        for lvl, g in enumerate(_grid(H, W) for (H, W) in shapes)], 0)[None]
    lo, hi = torch.tensor(0.01, dtype=f32), torch.tensor(0.99, dtype=f32)
    valid = ((props > lo) & (props < hi)).all(-1, keepdim=True)
    unsig = torch.log(props / (1 - props))
    unsig = torch.where(valid, unsig, torch.tensor(float("inf")))
    return valid.to(device), unsig.to(device, dtype)


def gen_encoder_output_proposals(memory, spatial_shapes):
    """utils.py:56-117 with no padding mask (B = 1): invalid proposals
    (any coordinate outside (0.01, 0.99)) are +inf and their memory rows
    zero."""
    valid, props_unsig = _proposals(tuple(map(tuple, spatial_shapes)),
                                    memory.device, memory.dtype)
    return torch.where(valid, memory, 0.0), props_unsig


# ---------------------------------------------------------------- forward

def encoder_layer(src, pos, reference_points, spatial_shapes, m: EncoderLayer,
                  num_heads: int = 8):
    """DeformableTransformerEncoderLayer (transformer.py:737-800)."""
    a = ms_deform_attn(src + pos, src, reference_points, spatial_shapes,
                       m.self_attn, num_heads=num_heads)
    src = layer_norm(src + a, m.norm1)
    h = linear(F.relu(linear(src, m.linear1)), m.linear2)
    return layer_norm(src + h, m.norm2)


def encoder_forward(src, pos, text, text_pad_mask, text_self_masks,
                    position_ids, spatial_shapes, m: Encoder,
                    num_heads: int = 8):
    """TransformerEncoder.forward (transformer.py:482-594). src / pos:
    (B, sum HW, C); text: (B, nt, C); text_pad_mask: (B, nt) True where
    PADDING; text_self_masks: (B, nt, nt) True where ALLOWED."""
    reference_points = get_reference_points(spatial_shapes, src)
    pos_text = text_pos_embed(position_ids, text)
    output = src
    for fusion, text_layer, layer in zip(m.fusion_layers, m.text_layers,
                                         m.layers):
        output, text = bi_attention_block(output, text, fusion, num_heads=4,
                                          mask_l=text_pad_mask)
        text = text_enhancer_layer(text, text_layer, num_heads=4,
                                   self_mask_bool=~text_self_masks,
                                   pos=pos_text)
        output = encoder_layer(output, pos, reference_points, spatial_shapes,
                               layer, num_heads)
    return output, text


def contrastive_embed(x, text, text_pad_mask, max_text_len: int = 256):
    """ContrastiveEmbed (utils.py:233-268): -inf on padded tokens, padded
    out to max_text_len with -inf."""
    res = torch.matmul(x, text.transpose(-1, -2))
    res = torch.where(text_pad_mask[:, None, :], float("-inf"), res)
    pad = res.new_full(res.shape[:-1] + (max_text_len - res.shape[-1],),
                       float("-inf"))
    return torch.cat([res, pad], dim=-1)


def decoder_layer(tgt, query_pos, reference_points_input, memory, text,
                  text_pad_mask, spatial_shapes, m: DecoderLayer,
                  num_heads: int = 8):
    """DeformableTransformerDecoderLayer (transformer.py:802-930)."""
    q = k = tgt + query_pos
    a = torch_mha(q, k, tgt, m.self_attn, num_heads)
    tgt = layer_norm(tgt + a, m.norm2)

    a = torch_mha(tgt + query_pos, text, text, m.ca_text, num_heads,
                  key_padding_mask=text_pad_mask)
    tgt = layer_norm(tgt + a, m.catext_norm)

    a = ms_deform_attn(tgt + query_pos, memory, reference_points_input,
                       spatial_shapes, m.cross_attn, num_heads=num_heads)
    tgt = layer_norm(tgt + a, m.norm1)

    h = linear(F.relu(linear(tgt, m.linear1)), m.linear2)
    return layer_norm(tgt + h, m.norm3)


def decoder_forward(tgt, refpoints_unsig, memory, text, text_pad_mask,
                    spatial_shapes, m: Decoder, bbox_embed: MLP,
                    num_heads: int = 8):
    """TransformerDecoder.forward (transformer.py:597-735): iterative box
    refinement with the shared box head on the un-normed output. Returns
    (the layer-normed outputs, the reference boxes: the initial one and one
    a layer)."""
    nlvl = len(spatial_shapes)
    reference_points = torch.sigmoid(refpoints_unsig)       # (B, nq, 4)
    intermediate, ref_points = [], [reference_points]
    output = tgt
    for layer in m.layers:
        ref_input = reference_points[:, :, None, :].expand(
            *reference_points.shape[:2], nlvl, 4)
        query_pos = mlp(gen_sineembed_for_position(reference_points),
                        m.ref_point_head)
        output = decoder_layer(output, query_pos, ref_input, memory, text,
                               text_pad_mask, spatial_shapes, layer,
                               num_heads)
        delta = mlp(output, bbox_embed)
        reference_points = torch.sigmoid(delta
                                         + inverse_sigmoid(reference_points))
        ref_points.append(reference_points)
        intermediate.append(layer_norm(output, m.norm))
    return intermediate, ref_points
