"""L1 + windowed SSIM losses for GS training.

Port of gs2mesh_tpu ops/ssim.py (the reference loss_utils.py:17-64: 11x11
Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero "same"
padding). The separable window runs as two band-matrix products, out =
Bv @ img @ Bh^T, in float32 ``torch.matmul``; a float32 matmul on the card
must not round through TF32, which keeps about 3 digits
(``torch.backends.cuda.matmul.allow_tf32`` is False by default, and the
trainer sets it, and cuDNN's flag, to False explicitly).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


@functools.lru_cache(maxsize=None)
def _band_matrix_np(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) band matrix: row i holds the 1-D Gaussian taps centred at i,
    truncated at the edges (== conv 'same' zero padding, no renorm)."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    B = np.zeros((n, n), np.float32)
    h = window_size // 2
    for t, gv in zip(range(-h, h + 1), g):
        B += np.diag(np.full(n - abs(t), gv), k=t)
    return B


@functools.lru_cache(maxsize=None)
def _band_matrix(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """The band matrix on ``device``, uploaded once."""
    return torch.from_numpy(_band_matrix_np(n, window_size, sigma)).to(device)


def _filter2d(img: torch.Tensor, window_size: int, sigma: float):
    """Separable Gaussian filter with zero 'same' padding; img (C, H, W)."""
    _, H, W = img.shape
    Bv = _band_matrix(H, window_size, sigma, img.device)
    Bh = _band_matrix(W, window_size, sigma, img.device)
    return torch.matmul(torch.matmul(Bv, img), Bh.T)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    k, sg = window_size, sigma
    mu1 = _filter2d(img1, k, sg)
    mu2 = _filter2d(img2, k, sg)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, k, sg) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, k, sg) - mu2_sq
    sigma12 = _filter2d(img1 * img2, k, sg) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def gs_loss(pred: torch.Tensor, target: torch.Tensor,
            lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - l) * L1 + l * (1 - SSIM), the GS training loss (train.py:91-92)."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * (1.0 - ssim(pred, target)))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
