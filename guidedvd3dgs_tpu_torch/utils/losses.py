"""Image losses and metrics: L1, PSNR, window SSIM and its per-pixel map.

Counterpart of `guidedvd3dgs_tpu/utils/losses.py`. Images are (C, H, W) or
(N, C, H, W). SSIM blurs with the 11x11, sigma 1.5 Gaussian window as a
depthwise `conv2d` with zero padding, as the original PyTorch SSIM does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(x - gt).mean()


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(N, 1) PSNR per batch item (a (C, H, W) input counts as N = 1)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def _ssim_window(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array(
        [np.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)]
    )
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int) -> torch.Tensor:
    c = img1.shape[1]
    window = torch.from_numpy(_ssim_window(window_size)).to(img1.device)
    window = window.expand(c, 1, window_size, window_size).contiguous()
    pad = window_size // 2

    def blur(x):
        return F.conv2d(x, window, padding=pad, groups=c)

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean window SSIM."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return _ssim_map(img1, img2, window_size).mean()


def ssim_noavg(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor | None = None,
               window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of the guidance loss (reference
    utils/loss_utils.py:86-117). With a mask, the masked-out pixels of both
    images are filled with 1 before the comparison."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
        if mask is not None:
            mask = mask[None]
    if mask is not None:
        img1 = img1 * mask + (1 - mask)
        img2 = img2 * mask + (1 - mask)
    out = _ssim_map(img1, img2, window_size)
    return out[0] if squeeze else out
