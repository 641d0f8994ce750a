"""Layers of the DLNR stereo net in NCHW, as plain functions over tensors and
the ``nn.Module`` that holds their weights.

The port's copy of gs2mesh_tpu stereo/layers.py. Each function takes the
module whose parameters it uses (an ``nn.Conv2d`` carries its own stride,
padding, dilation and groups); the modules' attribute names are the
reference torch modules' (DLNR/core/extractor.py, nets/feature.py), so a
released checkpoint loads with ``load_state_dict``.

Precision. Convolutions and matrix products run in float32 with TF32 off
(``core.precision.precision_scope``, which ``dlnr_forward`` enters), as the
JAX package's default does. ``matmul_dtype(torch.bfloat16)`` is the
counterpart of its bf16 policy: conv and matmul OPERANDS round to bf16;
norms, activations, softmax, sampling and the correlation lookup stay
float32. One rounding more than the JAX policy: JAX asks XLA for a float32
product of bf16 operands (``preferred_element_type``), while a bf16 cuDNN
convolution or cuBLAS product returns bf16, which is then widened to
float32.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

_MATMUL_DTYPE = contextvars.ContextVar("matmul_dtype", default=None)


@contextlib.contextmanager
def matmul_dtype(dtype):
    """Run conv / matmul operands in ``dtype`` inside the block (None =
    float32)."""
    token = _MATMUL_DTYPE.set(dtype)
    try:
        yield
    finally:
        _MATMUL_DTYPE.reset(token)


# ---------------------------------------------------------------- conv cores

def conv2d(x, conv: nn.Conv2d):
    """``conv`` applied to x (B, C, H, W) under the matmul policy; the bias is
    added in float32 after the product."""
    dt = _MATMUL_DTYPE.get()
    if dt is None:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                        conv.dilation, conv.groups)
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups).float()
    return y if conv.bias is None else y + conv.bias[:, None, None]


def conv_transpose_2x(x, conv: nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1) on the torch-layout (I, O, 4, 4)
    weight (the JAX package stores it flipped and IO-swapped instead)."""
    dt = _MATMUL_DTYPE.get()
    if dt is None:
        return F.conv_transpose2d(x, conv.weight, conv.bias, stride=2,
                                  padding=1)
    y = F.conv_transpose2d(x.to(dt), conv.weight.to(dt), None, stride=2,
                           padding=1).float()
    return y if conv.bias is None else y + conv.bias[:, None, None]


def matmul(a, b):
    """a @ b under the matmul policy (float32 out under a policy)."""
    dt = _MATMUL_DTYPE.get()
    if dt is None:
        return torch.matmul(a, b)
    return torch.matmul(a.to(dt), b.to(dt)).float()


# -------------------------------------------------------------------- norms

def layer_norm_bias(x, ln: "LayerNorm", eps=1e-5):
    """Restormer WithBias_LayerNorm over the channel axis."""
    mu = x.mean(1, keepdim=True)
    var = x.var(1, keepdim=True, correction=0)
    return ((x - mu) / torch.sqrt(var + eps) * ln.body.weight[:, None, None]
            + ln.body.bias[:, None, None])


def batch_norm_eval(x, bn: nn.BatchNorm2d):
    """BatchNorm2d in eval mode (running statistics)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False): per-sample, per-channel spatial norm."""
    mu = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps)


def group_norm(x, gn: nn.GroupNorm):
    b, c, h, w = x.shape
    g = x.reshape(b, gn.num_groups, c // gn.num_groups, h, w)
    mu = g.mean((2, 3, 4), keepdim=True)
    var = g.var((2, 3, 4), keepdim=True, correction=0)
    g = (g - mu) / torch.sqrt(var + gn.eps)
    return (g.reshape(b, c, h, w) * gn.weight[:, None, None]
            + gn.bias[:, None, None])


# ----------------------------------------------------------- restormer parts

class LayerNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.body = nn.Module()
        self.body.weight = nn.Parameter(torch.ones(c))
        self.body.bias = nn.Parameter(torch.zeros(c))


class FeedForward(nn.Module):
    """Gated-DConv feed-forward (extractor.py:122-140), bias-free."""

    def __init__(self, c, expansion=2.66):
        super().__init__()
        hidden = int(c * expansion)
        self.project_in = nn.Conv2d(c, 2 * hidden, 1, bias=False)
        self.dwconv = nn.Conv2d(2 * hidden, 2 * hidden, 3, padding=1,
                                groups=2 * hidden, bias=False)
        self.project_out = nn.Conv2d(hidden, c, 1, bias=False)


def gdfn(x, p: FeedForward):
    x = conv2d(conv2d(x, p.project_in), p.dwconv)
    x1, x2 = x.chunk(2, dim=1)
    return conv2d(F.gelu(x1) * x2, p.project_out)


class Attention(nn.Module):
    """Transposed (channel) attention (extractor.py:143-174)."""

    def __init__(self, c, heads):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Conv2d(c, 3 * c, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(3 * c, 3 * c, 3, padding=1, groups=3 * c,
                                    bias=False)
        self.project_out = nn.Conv2d(c, c, 1, bias=False)


def channel_attention(x, p: Attention):
    b, c, h, w = x.shape
    heads = p.temperature.shape[0]
    qkv = conv2d(conv2d(x, p.qkv), p.qkv_dwconv)
    q, k, v = (t.reshape(b, heads, c // heads, h * w)
               for t in qkv.chunk(3, dim=1))
    q = F.normalize(q, dim=-1, eps=1e-12)
    k = F.normalize(k, dim=-1, eps=1e-12)
    attn = matmul(q, k.transpose(-2, -1)) * p.temperature
    out = matmul(attn.softmax(dim=-1), v)
    return conv2d(out.reshape(b, c, h, w), p.project_out)


class TransformerBlock(nn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.norm1 = LayerNorm(c)
        self.attn = Attention(c, heads)
        self.norm2 = LayerNorm(c)
        self.ffn = FeedForward(c)


def transformer_block(x, p: TransformerBlock):
    x = x + channel_attention(layer_norm_bias(x, p.norm1), p.attn)
    return x + gdfn(layer_norm_bias(x, p.norm2), p.ffn)


def transformer_stack(n, c, heads):
    return nn.Sequential(*(TransformerBlock(c, heads) for _ in range(n)))


def run_stack(x, stack: nn.Sequential):
    for block in stack:
        x = transformer_block(x, block)
    return x


class Resample(nn.Module):
    """Downsample / Upsample's conv (``body.0``; the pixel (un)shuffle that
    follows it in the reference's Sequential holds no weights)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1,
                                            bias=False))


def downsample(x, p: Resample):
    """conv C -> C/2 then PixelUnshuffle(2): 2C at half resolution (torch's
    channel order c·r² + i·r + j, which the JAX package reproduces)."""
    return F.pixel_unshuffle(conv2d(x, p.body[0]), 2)


def upsample(x, p: Resample):
    """conv C -> 2C then PixelShuffle(2): C/2 at double resolution."""
    return F.pixel_shuffle(conv2d(x, p.body[0]), 2)


# ----------------------------------------------------------- RAFT-style parts

class ResidualBlock(nn.Module):
    """ResidualBlock(norm='instance', stride=1) (extractor.py:9-62)."""

    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)


def residual_block_instance(x, p: ResidualBlock):
    y = F.relu(instance_norm(conv2d(x, p.conv1)))
    y = F.relu(instance_norm(conv2d(y, p.conv2)))
    return F.relu(x + y)


class BasicConv(nn.Module):
    """GANet BasicConv: conv or 4x4 stride-2 deconv (no bias) + BatchNorm
    (nets/feature.py:312-337)."""

    def __init__(self, cin, cout, deconv=False, stride=1, padding=1,
                 dilation=1):
        super().__init__()
        self.conv = (nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
                     if deconv else
                     nn.Conv2d(cin, cout, 3, stride=stride, padding=padding,
                               dilation=dilation, bias=False))
        self.bn = nn.BatchNorm2d(cout)


def basic_conv(x, p: BasicConv, relu=True):
    if isinstance(p.conv, nn.ConvTranspose2d):
        y = conv_transpose_2x(x, p.conv)
    else:
        y = conv2d(x, p.conv)
    y = batch_norm_eval(y, p.bn)
    return F.relu(y) if relu else y


class Conv2x(nn.Module):
    """GANet Conv2x (nets/feature.py:340-374): 2x down (conv k3 s2) or up
    (deconv k4 s2), concat the skip, conv 3x3. (The reference's mdconv flag
    is dead code: conv2 is always a plain BasicConv.)"""

    def __init__(self, cin, cout, deconv=False):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, deconv=deconv, stride=2)
        self.conv2 = BasicConv(2 * cout, cout)


def conv2x(x, rem, p: Conv2x):
    x = basic_conv(x, p.conv1)
    return basic_conv(torch.cat([x, rem], dim=1), p.conv2)


def avg_pool_2x(x):
    """F.avg_pool2d(x, 3, stride=2, padding=1), count_include_pad=True (the
    torch default, update.py:111-112)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def interp_bilinear(x, out_h, out_w):
    """F.interpolate(mode='bilinear', align_corners=True)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)
