"""Image metrics (``crnerf_tpu/train/metrics.py``): PSNR."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(MSE), in dB for values in [0, 1]."""
    return -10.0 * torch.log10(mse(pred, gt))
