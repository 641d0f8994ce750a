"""Vision-language fusion and the text-enhancer layer, the port of
gs2mesh_tpu gdino/fusion.py: fuse_modules.py's BiMultiHeadAttention /
BiAttentionBlock (with layer scale) and transformer_vanilla.py's
TransformerEncoderLayer over the text tokens, whose attention is
nn.MultiheadAttention's packed-projection layout. Every softmax attention
is written out (nn.MultiheadAttention masks differently).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import Norm, layer_norm, linear

KEY_PAD_NEG = -1e30


# ------------------------------------------------------------------ modules

class MHA(nn.Module):
    """nn.MultiheadAttention's weights: packed ``in_proj_weight`` (3C, C),
    ``in_proj_bias`` and ``out_proj``."""

    def __init__(self, C: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * C, C))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * C))
        self.out_proj = nn.Linear(C, C)


class TextEnhancerLayer(nn.Module):
    def __init__(self, C: int = 256, ffn: int = 1024):
        super().__init__()
        self.self_attn = MHA(C)
        self.norm1 = Norm(C)
        self.linear1 = nn.Linear(C, ffn)
        self.linear2 = nn.Linear(ffn, C)
        self.norm2 = Norm(C)


class BiMultiHeadAttention(nn.Module):
    def __init__(self, C: int = 256, embed: int = 1024):
        super().__init__()
        self.v_proj = nn.Linear(C, embed)
        self.l_proj = nn.Linear(C, embed)
        self.values_v_proj = nn.Linear(C, embed)
        self.values_l_proj = nn.Linear(C, embed)
        self.out_v_proj = nn.Linear(embed, C)
        self.out_l_proj = nn.Linear(embed, C)


class BiAttentionBlock(nn.Module):
    def __init__(self, C: int = 256, embed: int = 1024):
        super().__init__()
        self.layer_norm_v = Norm(C)
        self.layer_norm_l = Norm(C)
        self.attn = BiMultiHeadAttention(C, embed)
        self.gamma_v = nn.Parameter(torch.zeros(C))
        self.gamma_l = nn.Parameter(torch.zeros(C))


# ---------------------------------------------------------------- forward

def torch_mha(q, k, v, m: MHA, num_heads: int, attn_mask=None,
              key_padding_mask=None):
    """nn.MultiheadAttention on batch-first tensors. attn_mask: additive
    (B, Nq, Nk) or (Nq, Nk); key_padding_mask: (B, Nk) True where padded
    (its scores become -1e30)."""
    B, Nq, C = q.shape
    w, b = m.in_proj_weight, m.in_proj_bias
    qp = F.linear(q, w[:C], b[:C])
    kp = F.linear(k, w[C:2 * C], b[C:2 * C])
    vp = F.linear(v, w[2 * C:], b[2 * C:])
    d = C // num_heads

    def heads(t):
        return t.reshape(B, -1, num_heads, d).transpose(1, 2)

    attn = torch.matmul(heads(qp), heads(kp).transpose(-1, -2)) \
        / math.sqrt(d)
    if attn_mask is not None:
        mask = attn_mask if attn_mask.ndim == 3 else attn_mask[None]
        attn = attn + mask[:, None]
    if key_padding_mask is not None:
        attn = torch.where(key_padding_mask[:, None, None, :], KEY_PAD_NEG,
                           attn)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn, heads(vp)).transpose(1, 2).reshape(B, Nq, C)
    return linear(out, m.out_proj)


def text_enhancer_layer(x, m: TextEnhancerLayer, num_heads: int,
                        self_mask_bool, pos):
    """TransformerEncoderLayer (the position added to q and k, post-LN).
    x: (B, N, C); self_mask_bool: (B, N, N) True where attention is
    BLOCKED (the reference passes ~text_self_attention_masks)."""
    add_mask = torch.where(self_mask_bool, float("-inf"), 0.0).to(x.dtype)
    q = k = x + pos
    a = torch_mha(q, k, x, m.self_attn, num_heads, attn_mask=add_mask)
    x = layer_norm(x + a, m.norm1)
    h = linear(F.relu(linear(x, m.linear1)), m.linear2)
    return layer_norm(x + h, m.norm2)


def bi_attention(v, l, m: BiMultiHeadAttention, num_heads: int, mask_v=None,
                 mask_l=None):
    """BiMultiHeadAttention (fuse_modules.py:99-245). v: (B, nv, C); l:
    (B, nl, C); masks True where PADDED. The first stabilising max is over
    the whole score tensor (stable_softmax_2d), then the ±50,000 clip."""
    B, nv, _ = v.shape
    embed = m.v_proj.weight.shape[0]
    d = embed // num_heads
    scale = d ** -0.5

    def heads(t):
        return t.reshape(B, -1, num_heads, d).transpose(1, 2)

    q = heads(linear(v, m.v_proj) * scale)
    k = heads(linear(l, m.l_proj))
    vv = heads(linear(v, m.values_v_proj))
    vl = heads(linear(l, m.values_l_proj))

    attn = torch.matmul(q, k.transpose(-1, -2))         # (B, h, nv, nl)
    attn = attn - attn.max()
    attn = attn.clamp(-50000, 50000)

    attn_T = attn.transpose(-1, -2)                      # (B, h, nl, nv)
    attn_l = attn_T - attn_T.amax(dim=-1, keepdim=True)
    attn_l = attn_l.clamp(-50000, 50000)
    if mask_v is not None:
        attn_l = torch.where(mask_v[:, None, None, :], float("-inf"),
                             attn_l)
    attn_l = torch.softmax(attn_l, dim=-1)

    if mask_l is not None:
        attn = torch.where(mask_l[:, None, None, :], float("-inf"), attn)
    attn_v = torch.softmax(attn, dim=-1)

    out_v = torch.matmul(attn_v, vl).transpose(1, 2).reshape(B, nv, embed)
    out_l = torch.matmul(attn_l, vv).transpose(1, 2).reshape(B, -1, embed)
    return linear(out_v, m.out_v_proj), linear(out_l, m.out_l_proj)


def bi_attention_block(v, l, m: BiAttentionBlock, num_heads: int,
                       mask_v=None, mask_l=None):
    """BiAttentionBlock (fuse_modules.py:248-296): pre-LN, and the layer
    scale's ``gamma * delta`` added to the NORMED inputs."""
    vn = layer_norm(v, m.layer_norm_v)
    ln = layer_norm(l, m.layer_norm_l)
    dv, dl = bi_attention(vn, ln, m.attn, num_heads, mask_v, mask_l)
    return vn + m.gamma_v * dv, ln + m.gamma_l * dl
