"""1-D correlation pyramid and its windowed bilinear lookup.

The port's copy of gs2mesh_tpu stereo/corr.py (DLNR's CorrBlock1D,
core/corr.py:103-149): an all-pairs per-row cost volume as one batched
matrix product, a 1x2 average pyramid, and a lookup that gathers the 2r+2
consecutive integer taps around floor(x) of each level. Both the JAX
package's compare-mask-reduce lookup (a TPU workaround that would build a
(B, H, W1, W2) tensor per tap here) and this gather pick the same single
value per tap, so they agree to the rounding of the lerp.
"""

from __future__ import annotations

import math

import torch

from gs2mesh_torch.stereo.layers import matmul


def build_corr_pyramid(fmap1, fmap2, num_levels=4):
    """fmap1/2: (B, D, H, W). Returns [(B, H, W1, W2 / 2^i)] for i < levels,
    corr[b, h, w1, w2] = <fmap1[b, :, h, w1], fmap2[b, :, h, w2]> / sqrt(D);
    the product follows the matmul policy (layers.matmul_dtype)."""
    d = fmap1.shape[1]
    corr = matmul(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 1, 3))
    corr = corr / math.sqrt(d)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        b, h, w1, w2 = corr.shape
        corr = corr.reshape(b, h, w1, w2 // 2, 2).mean(-1)   # avg pool 1x2
        pyramid.append(corr)
    return pyramid


def lookup_corr(pyramid, coords_x, radius=4):
    """coords_x: (B, H, W1) x coordinate in 1/4-resolution pixels.

    Returns (B, levels * (2r+1), H, W1) bilinear samples at x / 2^i + k,
    k in [-r, r], zero outside [0, W2-1] as grid_sample(align_corners=True,
    zeros padding) gives them (bilinear_sampler, core/utils/utils.py:64-79):
    a tap at integer position p takes corr[p] if 0 <= p <= W2-1, else 0."""
    out = []
    offsets = torch.arange(-radius, radius + 2, device=coords_x.device)
    for i, corr in enumerate(pyramid):
        w2 = corr.shape[-1]
        x = coords_x / (2 ** i)
        x0 = torch.floor(x)
        t = (x - x0)[..., None]
        idx = x0.long()[..., None] + offsets                 # (B,H,W1,2r+2)
        inside = (idx >= 0) & (idx <= w2 - 1)
        v = torch.gather(corr, -1, idx.clamp(0, w2 - 1)) * inside
        out.append(v[..., :-1] * (1.0 - t) + v[..., 1:] * t)
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)
