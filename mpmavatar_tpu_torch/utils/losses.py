"""Training losses, port of mpmavatar_tpu/utils/losses.py (L1, L2, PSNR,
windowed SSIM).  Images are (C, H, W) or (B, C, H, W) in [0, 1].

SSIM's separable gaussian filter is, as in the JAX package, two banded
Toeplitz matrix products (one per image axis, zero padding, the same
11-tap window) over the five stacked moments: plain matrix products in
full float32 (the package pins TF32 off), no kernel of the port's own.
The band matrices are built once per (size, window, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, device: str, sigma: float = 1.5):
    """(n, n) Toeplitz band M with M[o, i] = g[i - o + r] (zero outside):
    M @ x == zero-padded SAME 1-D gaussian filtering along that axis."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    r = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k, gk in zip(range(-r, r + 1), g):
        idx = np.arange(max(0, -k), min(n, n - k))
        m[idx, idx + k] = gk
    return torch.as_tensor(m, device=device)


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """Windowed SSIM: the five filtered moments as one pair of band
    products, M_h @ x @ M_w^T."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    h, w = img1.shape[-2:]
    dev = str(img1.device)
    mh = _band_matrix(h, window_size, dev)
    mw = _band_matrix(w, window_size, dev)
    stacked = torch.stack([img1, img2, img1 * img1, img2 * img2,
                           img1 * img2])                  # (5, B, C, H, W)
    mu1, mu2, m11, m22, m12 = mh @ stacked @ mw.T
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))
