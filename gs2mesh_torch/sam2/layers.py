"""Shared layers of the SAM2 port: token-major (B, N, C) and channels-last
(B, H, W, C) tensors, as in gs2mesh_tpu sam2/layers.py.

The weights live in ``nn.Module``s whose attribute names are the reference
torch modules' (sam2/modeling/*), so a released checkpoint loads with
``load_state_dict``; the functions here take the module whose parameters
they use. Linear weights are torch's (out, in), conv weights (O, I, kh, kw);
convolutions run on a channels-last view of the NHWC activations. Every
function follows the input's dtype (float32, or float64 for the card
against the CPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# ------------------------------------------------------------------ modules

class MLP(nn.Module):
    """sam2_utils.py:MLP: ``layers.{i}`` linears, the activation between
    them."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))


class Attention(nn.Module):
    """sam/transformer.py:Attention's projections (internal dim
    ``internal``, keys and values from ``kv_in`` channels)."""

    def __init__(self, dim, internal, kv_in=None):
        super().__init__()
        kv_in = kv_in or dim
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(kv_in, internal)
        self.v_proj = nn.Linear(kv_in, internal)
        self.out_proj = nn.Linear(internal, dim)


class Norm(nn.Module):
    """LayerNorm / LayerNorm2d parameters (``weight``, ``bias``); the eps is
    the caller's, as in the JAX package."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class Named(nn.Module):
    """A module holding one named child (nn.Sequential's ``add_module``
    naming of the reference, e.g. the neck's ``convs.{i}.conv``)."""

    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            self.add_module(k, v)


# ------------------------------------------------------------------ basics

def linear(x, m: nn.Linear):
    return F.linear(x, m.weight, m.bias)


def layer_norm(x, m: Norm, eps=1e-5):
    """LayerNorm over the last axis (C)."""
    return F.layer_norm(x, x.shape[-1:], m.weight, m.bias, eps)


def layer_norm_2d(x, m: Norm, eps=1e-6):
    """LayerNorm2d (sam2_utils.py): the channel norm, on NHWC here."""
    return F.layer_norm(x, x.shape[-1:], m.weight, m.bias, eps)


def conv2d(x, m: nn.Conv2d):
    """``m`` (with its stride, padding and groups) on NHWC ``x``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), m.weight, m.bias, m.stride,
                 m.padding, m.dilation, m.groups)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d_s2(x, m: nn.ConvTranspose2d):
    """ConvTranspose2d(k=2, stride=2) on NHWC ``x``; torch's (I, O, k, k)
    weight (the JAX package stores it flipped and IO-swapped)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), m.weight, m.bias,
                           stride=2)
    return y.permute(0, 2, 3, 1)


def gelu_tanh(x):
    """jax.nn.gelu's default (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def mlp(x, m: MLP, activation=F.relu, sigmoid_output: bool = False):
    """MaskFormer-style MLP: the activation after all but the last layer."""
    n = len(m.layers)
    for i, layer in enumerate(m.layers):
        x = linear(x, layer)
        if i < n - 1:
            x = activation(x)
    return torch.sigmoid(x) if sigmoid_output else x


def sdpa(q, k, v):
    """softmax(q kᵀ / √d) v, written out: q/k/v (B, heads, N, d)."""
    attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(attn, dim=-1), v)


# --------------------------------------------------------------- attention

def _split_heads(x, num_heads):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention(q, k, v, m: Attention, num_heads: int):
    """SAM Attention (sam/transformer.py:Attention)."""
    out = sdpa(_split_heads(linear(q, m.q_proj), num_heads),
               _split_heads(linear(k, m.k_proj), num_heads),
               _split_heads(linear(v, m.v_proj), num_heads))
    return linear(_merge_heads(out), m.out_proj)


# -------------------------------------------------------------------- RoPE

def axial_rope_angles(dim: int, end_x: int, end_y: int,
                      theta: float = 10000.0) -> np.ndarray:
    """(end_x*end_y, dim/2) rotation angles; the first dim/4 rotate by x
    position, the second dim/4 by y
    (position_encoding.py:compute_axial_cis)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4] / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    t_x, t_y = t % end_x, t // end_x
    ang = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], -1)
    return ang.astype(np.float32)


def apply_rotary(x, cos, sin):
    """x: (B, H, N, d); cos/sin: (N, d/2). Rotates the interleaved (even,
    odd) pairs in real arithmetic."""
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.reshape(x.shape)


def rope_tables(dim: int, end_x: int, end_y: int, like: torch.Tensor):
    """cos and sin of ``axial_rope_angles``, computed in float32 (as the JAX
    package does) on the host, then moved to ``like``'s device and dtype:
    the card's float32 cos and sin round apart from the CPU's, and the
    tables are constants of the grid, the same on every device. Cached per
    grid, device and dtype: the tensors are shared, read them only."""
    return _rope_tables(dim, end_x, end_y, like.device, like.dtype)


@functools.lru_cache(maxsize=16)
def _rope_tables(dim, end_x, end_y, device, dtype):
    a = torch.from_numpy(axial_rope_angles(dim, end_x, end_y))
    return torch.cos(a).to(device, dtype), torch.sin(a).to(device, dtype)


def rope_attention(q, k, v, m: Attention, num_heads: int, rope,
                   num_k_exclude_rope: int = 0, rope_k_repeat: bool = False):
    """RoPEAttention (sam/transformer.py:284-): the rotary encoding on q and
    on the first len(k) - num_k_exclude_rope keys. ``rope``: (cos, sin)."""
    qh = _split_heads(linear(q, m.q_proj), num_heads)
    kh = _split_heads(linear(k, m.k_proj), num_heads)
    vh = _split_heads(linear(v, m.v_proj), num_heads)
    cos, sin = rope
    num_k_rope = kh.shape[2] - num_k_exclude_rope
    if rope_k_repeat and num_k_rope != qh.shape[2]:
        r = num_k_rope // qh.shape[2]
        k_cos, k_sin = cos.repeat(r, 1), sin.repeat(r, 1)
    else:
        k_cos, k_sin = cos, sin
    qh = apply_rotary(qh, cos, sin)
    k_rot = apply_rotary(kh[:, :, :num_k_rope], k_cos, k_sin)
    kh = (torch.cat([k_rot, kh[:, :, num_k_rope:]], dim=2)
          if num_k_exclude_rope > 0 else k_rot)
    return linear(_merge_heads(sdpa(qh, kh, vh)), m.out_proj)


# --------------------------------------------------------- position embeds

def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int, like: torch.Tensor,
                      temperature: float = 10000.0,
                      scale: float = 2 * math.pi):
    """PositionEmbeddingSine.forward (normalized) -> (H, W, C), computed in
    float32 on the host (as ``rope_tables``, and cached as it is), then
    moved to ``like``'s device and dtype."""
    return _sine_table(h, w, num_pos_feats, temperature, scale, like.device,
                       like.dtype)


@functools.lru_cache(maxsize=16)
def _sine_table(h, w, num_pos_feats, temperature, scale, device, dtype):
    f32 = torch.float32
    half = num_pos_feats // 2
    y = torch.arange(1, h + 1, dtype=f32)[:, None] * torch.ones(1, w)
    x = torch.arange(1, w + 1, dtype=f32)[None, :] * torch.ones(h, 1)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = torch.arange(half, dtype=f32)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / half)

    def sin_cos(p):
        return torch.stack([torch.sin(p[:, :, 0::2]),
                            torch.cos(p[:, :, 1::2])], dim=3).reshape(h, w, -1)

    pos = torch.cat([sin_cos(y[:, :, None] / dim_t),
                     sin_cos(x[:, :, None] / dim_t)], dim=-1)
    return pos.to(device, dtype)


def get_1d_sine_pe(pos, dim: int, temperature: float = 10000.0):
    """(N,) positions -> (N, dim) embedding (sam2_utils.py:get_1d_sine_pe)."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / pe_dim)
    pe = pos[:, None] / dim_t
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=-1)


def random_pe_coords(gauss_matrix, coords):
    """coords in [0, 1] -> sin/cos features (PositionEmbeddingRandom)."""
    c = 2 * math.pi * ((2 * coords - 1) @ gauss_matrix)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def random_pe_grid(gauss_matrix, h: int, w: int):
    """PositionEmbeddingRandom.forward -> (H, W, C); the float32 grid is
    made on the host (as ``rope_tables``)."""
    y = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    coords = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)],
                         dim=-1).to(gauss_matrix.device, gauss_matrix.dtype)
    return random_pe_coords(gauss_matrix, coords)


# ---------------------------------------------------------------- windows

def window_partition(x, window_size: int):
    """(B, H, W, C) -> (B*nW, ws, ws, C), zero-padded to multiples."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size,
                  window_size, C)
    return (x.permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, window_size, window_size, C)), (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size,
                        window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


# ------------------------------------------------------------------ resizes

def resize_linear(x, out_h: int, out_w: int):
    """jax.image.resize(method="linear") of the last two axes of a (B, C,
    H, W) tensor: half-pixel bilinear, antialiased (a triangle filter
    widened by the scale) along an axis that shrinks."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False,
                         antialias=out_h < h or out_w < w)


def resize_nearest(x, out_h: int, out_w: int):
    """jax.image.resize(method="nearest") of the last two axes: source index
    floor((i + 0.5) * in / out), with JAX's float32 arithmetic, on the host
    (CUDA would divide by the host scalar as a reciprocal product)."""
    h, w = x.shape[-2:]

    def index(n_in, n_out):
        i = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(i).to(torch.int64).clamp_(max=n_in - 1).to(
            x.device)

    return x.index_select(-2, index(h, out_h)).index_select(-1,
                                                            index(w, out_w))


def interpolate_nearest_2x(x):
    """scale_factor=2 nearest on NHWC (the FPN top-down path)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
