"""Memory attention + memory encoder, the port of gs2mesh_tpu sam2/memory.py
(sam2/modeling/{memory_attention,memory_encoder}.py): the streaming memory
transformer that conditions the current frame's features on past spatial
memories and object pointers (RoPE self / cross attention), and the
ConvNeXt-style encoder fusing a predicted mask with the pixel features.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import (Attention, Norm, conv2d, layer_norm,
                                       layer_norm_2d, linear, rope_attention,
                                       rope_tables, sine_pos_embed_2d)


# ------------------------------------------------------------------ modules

class MemoryAttentionLayer(nn.Module):
    def __init__(self, C: int, mem_dim: int, ffn: int = 2048):
        super().__init__()
        self.self_attn = Attention(C, C)
        self.cross_attn_image = Attention(C, C, kv_in=mem_dim)
        self.linear1 = nn.Linear(C, ffn)
        self.linear2 = nn.Linear(ffn, C)
        self.norm1, self.norm2, self.norm3 = Norm(C), Norm(C), Norm(C)


class MemoryAttention(nn.Module):
    def __init__(self, C: int, mem_dim: int, num_layers: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(C, mem_dim)
                                    for _ in range(num_layers))
        self.norm = Norm(C)


def _mask_downsampler_layers(out: int):
    chans = [1, 4, 16, 64, 256]
    mods = []
    for cin, cout in zip(chans[:-1], chans[1:]):
        mods += [nn.Conv2d(cin, cout, 3, 2, 1), Norm(cout), nn.GELU()]
    return nn.Sequential(*mods, nn.Conv2d(256, out, 1))


class MaskDownSampler(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.encoder = _mask_downsampler_layers(C)


class CXBlock(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.dwconv = nn.Conv2d(C, C, 7, padding=3, groups=C)
        self.norm = Norm(C)
        self.pwconv1 = nn.Linear(C, 4 * C)
        self.pwconv2 = nn.Linear(4 * C, C)
        self.gamma = nn.Parameter(torch.full((C,), 1e-6))


class Fuser(nn.Module):
    def __init__(self, C: int, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(C) for _ in range(num_layers))


class MemoryEncoder(nn.Module):
    def __init__(self, C: int, mem_dim: int):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(C)
        self.pix_feat_proj = nn.Conv2d(C, C, 1)
        self.fuser = Fuser(C)
        self.out_proj = nn.Conv2d(C, mem_dim, 1)


# ------------------------------------------------------------------ forward

def memory_attention_layer(m: MemoryAttentionLayer, tgt, memory, pos, rope,
                           num_k_exclude_rope: int):
    """MemoryAttentionLayer (memory_attention.py:18-100): relu FFN, the
    position encoding at the cross-attention keys only."""
    t2 = layer_norm(tgt, m.norm1)
    tgt = tgt + rope_attention(t2, t2, t2, m.self_attn, 1, rope)
    t2 = layer_norm(tgt, m.norm2)
    tgt = tgt + rope_attention(t2, memory + pos, memory, m.cross_attn_image,
                               1, rope,
                               num_k_exclude_rope=num_k_exclude_rope,
                               rope_k_repeat=True)
    t2 = layer_norm(tgt, m.norm3)
    return tgt + linear(F.relu(linear(t2, m.linear1)), m.linear2)


def memory_attention(m: MemoryAttention, curr, curr_pos, memory, memory_pos,
                     num_obj_ptr_tokens: int, feat_hw):
    """MemoryAttention.forward (memory_attention.py:103-170), batch first.
    curr / curr_pos: (B, HW, C); memory / memory_pos: (B, M, mem_dim).

    One 256-dim RoPE table over the feature grid serves self and cross
    attention (both project to 256); the cross-attention keys repeat it per
    memory frame, and the object-pointer tokens skip it."""
    output = curr + 0.1 * curr_pos
    h, w = feat_hw
    rope = rope_tables(256, w, h, curr)
    for layer in m.layers:
        output = memory_attention_layer(layer, output, memory, memory_pos,
                                        rope, num_obj_ptr_tokens)
    return layer_norm(output, m.norm)


def mask_downsampler(m: MaskDownSampler, x):
    """MaskDownSampler (memory_encoder.py:17-57): four stride-2 convs with
    LayerNorm2d and GELU, then a 1x1 projection. x: (B, H, W, 1)."""
    enc = m.encoder
    n = (len(enc) - 1) // 3
    for i in range(n):
        x = F.gelu(layer_norm_2d(conv2d(x, enc[3 * i]), enc[3 * i + 1]))
    return conv2d(x, enc[3 * n])


def cx_block(m: CXBlock, x):
    """ConvNeXt CXBlock (memory_encoder.py:61-117), NHWC."""
    y = layer_norm_2d(conv2d(x, m.dwconv), m.norm, eps=1e-6)
    y = linear(F.gelu(linear(y, m.pwconv1)), m.pwconv2)
    return x + m.gamma * y


def memory_encoder(m: MemoryEncoder, pix_feat, mask_probs,
                   pos_feats: int = 64):
    """MemoryEncoder.forward (memory_encoder.py:137-182). pix_feat: (B, H,
    W, C); mask_probs: (B, 16H, 16W, 1), already scaled sigmoid
    probabilities. Returns (features (B, H, W, mem_dim), pos (H, W,
    mem_dim))."""
    x = conv2d(pix_feat, m.pix_feat_proj) + mask_downsampler(
        m.mask_downsampler, mask_probs)
    for layer in m.fuser.layers:
        x = cx_block(layer, x)
    x = conv2d(x, m.out_proj)
    return x, sine_pos_embed_2d(x.shape[1], x.shape[2], pos_feats, x)
