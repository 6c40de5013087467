"""Image losses and metrics on tensors: L1, SSIM, PSNR.

Port of msgs/eval/metrics.py with its numerical contract: ssim uses an
11×11 Gaussian window, σ=1.5, a same-padded depthwise convolution,
C1=0.01², C2=0.03²; psnr is 20·log10(1/√mse) over the whole image. Images
are channels-last (H, W, C) at every public function. The convolution runs
in full float32 (msgs_torch turns cuDNN's TF32 off).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def psnr(img, gt):
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    w = np.outer(g, g)
    return w.astype(np.float32)


def _filter2d(img, win):
    """Depthwise same-padded 2-D convolution; img (H, W, C)."""
    C = img.shape[-1]
    k = torch.as_tensor(win, device=img.device)[None, None]
    k = k.repeat(C, 1, 1, 1)                            # depthwise
    x = img.permute(2, 0, 1)[None]                      # (1, C, H, W)
    # On the CPU, torch's own convolution: oneDNN's depthwise kernel
    # (jit_dw) comes out about one ulp high on average against a float64
    # convolution, a bias the image mean keeps, which put a 64×64 SSIM
    # 1.1e-6 off the JAX package's (tests/test_torch_eval_apps.py); the
    # native path is within 2e-7 of float64 and unbiased. CUDA tensors are
    # unaffected (cuDNN).
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        out = F.conv2d(x, k, padding=win.shape[0] // 2, groups=C)
    return out[0].permute(1, 2, 0)


def ssim_map(img, gt, window_size: int = 11, sigma: float = 1.5):
    """Per-pixel SSIM map with zero-padded SAME convolutions."""
    win = _gaussian_window(window_size, sigma)
    mu1 = _filter2d(img, win)
    mu2 = _filter2d(gt, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img * img, win) - mu1_sq
    sigma2_sq = _filter2d(gt * gt, win) - mu2_sq
    sigma12 = _filter2d(img * gt, win) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img, gt, window_size: int = 11, sigma: float = 1.5):
    return torch.mean(ssim_map(img, gt, window_size, sigma))


def photometric_loss(img, gt, lambda_dssim: float = 0.2):
    """(1−λ)·L1 + λ·(1−SSIM), the training loss."""
    return ((1.0 - lambda_dssim) * l1_loss(img, gt)
            + lambda_dssim * (1.0 - ssim(img, gt)))
