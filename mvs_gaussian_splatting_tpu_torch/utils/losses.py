"""Image losses and metrics.

Port of the JAX package's ``utils/losses.py``: L1, MSE, PSNR and the
reference's SSIM (11×11 Gaussian window, σ 1.5, per-channel 'same'
correlation with zero padding window//2, C1 = 0.01², C2 = 0.03²). The
window is separable, so the blur is two grouped 1-D ``F.conv2d`` passes,
the same operator as the JAX package's two tap passes up to the f32
summation order. The package turns TF32 off for cuDNN convolutions, so the
passes run in full f32 on a card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return ((pred - target) ** 2).mean()


def mse(img1, img2):
    """Per-image MSE over flattened pixels; inputs [..., C, H, W] → [..., 1]."""
    flat = ((img1 - img2) ** 2).reshape(img1.shape[:-3] + (-1,))
    return flat.mean(dim=-1, keepdim=True)


def psnr(img1, img2):
    """Per-image PSNR (flattened-batch convention of the reference)."""
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def _gaussian_taps(window_size: int, sigma: float, device) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2)
                               / (2 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float32)
    return (g / g.sum()).to(device)


def _blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """[M, H, W] maps → each correlated with outer(taps, taps), zero
    padding, 'same' size: a horizontal then a vertical grouped pass."""
    m = x.shape[0]
    k = taps.shape[0]
    r = k // 2
    y = F.conv2d(x[None], taps.view(1, 1, 1, k).expand(m, 1, 1, k),
                 padding=(0, r), groups=m)
    y = F.conv2d(y, taps.view(1, 1, k, 1).expand(m, 1, k, 1),
                 padding=(r, 0), groups=m)
    return y[0]


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over [C, H, W] images in [0, 1], reference-exact."""
    taps = _gaussian_taps(window_size, 1.5, img1.device)
    c = img1.shape[0]
    # one stacked blur for all five maps
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    blurred = _blur(stack, taps)
    mu1, mu2, m11, m22, m12 = (blurred[i * c:(i + 1) * c] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def dssim_l1_loss(pred, target, lambda_dssim: float = 0.2):
    """The training loss: (1-λ)·L1 + λ·(1-SSIM), train.py:99-101."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * (1.0 - ssim(pred, target)))
