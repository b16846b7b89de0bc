"""Image metrics (``crnerf_tpu/train/metrics.py``): MSE and PSNR, with an
optional ``valid_mask``, and SSIM as kornia computes it: a Gaussian window
(3x3, sigma 1.5) over reflect-padded images, c1 = (0.01 max_val)^2, c2 =
(0.03 max_val)^2.

The JAX package filters at ``Precision.HIGHEST``. Here the 3x3 window is
nine shifted fp32 multiply-adds on the padded tensor, not a depthwise
``F.conv2d``: on the card cuDNN would be free to run that convolution in
TF32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, gt: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; with ``valid_mask`` (boolean, indexing the
    leading dimensions of the squared difference) over the valid entries
    only."""
    v = (pred - gt) ** 2
    if valid_mask is not None:
        v = v[valid_mask]
    return torch.mean(v)


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-10 log10(MSE), in dB for values in [0, 1]."""
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))


def _gaussian_kernel2d(window_size: int, sigma: float) -> np.ndarray:
    """kornia's window: a Gaussian at integer offsets from the centre,
    normalised to sum 1, as an outer product (float32)."""
    x = np.arange(window_size, dtype=np.float64) - (window_size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def _filter2d_reflect(x: torch.Tensor, k2d: np.ndarray) -> torch.Tensor:
    """Depthwise filter of NCHW ``x`` with reflect padding, as shifted
    multiply-adds in fp32."""
    kh, kw = k2d.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (pw, pw, ph, ph), mode="reflect")
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    for dy in range(kh):
        for dx in range(kw):
            out = out + float(k2d[dy, dx]) * xp[..., dy:dy + h, dx:dx + w]
    return out


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 3,
             max_val: float = 1.0, sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map of NHWC images in [0, max_val] (NHWC out)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k2d = _gaussian_kernel2d(window_size, sigma)
    a = img1.float().permute(0, 3, 1, 2)
    b = img2.float().permute(0, 3, 1, 2)
    mu1 = _filter2d_reflect(a, k2d)
    mu2 = _filter2d_reflect(b, k2d)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1_sq = _filter2d_reflect(a * a, k2d) - mu1_sq
    s2_sq = _filter2d_reflect(b * b, k2d) - mu2_sq
    s12 = _filter2d_reflect(a * b, k2d) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1_sq + s2_sq + c2)
    return (num / den).permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 3,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM of NHWC or HWC images."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean(ssim_map(img1, img2, window_size, max_val))
