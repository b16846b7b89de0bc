"""Appearance (style) encoder (``crnerf_tpu/models/appearance.py``
``AppearanceEncoder``, plain schedule): a small VGG-like conv stack over the
whole [0, 1] image with two 2x2 maxpools, an adaptive average pool to
32x32 and a 1x1 projection -> the (N, 32, 32, C) style embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crnerf_tpu_torch.models.common import (
    ConvRefl,
    adaptive_avg_pool2d_nchw,
    conv,
    leaky_relu,
    nchw,
    nhwc,
)


class AppearanceEncoder(nn.Module):
    def __init__(self, out_channel: int = 64, pool_hw: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_hw = pool_hw
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 3, 1)
        self.conv2 = ConvRefl(3, 64)
        self.conv3 = ConvRefl(64, 64)
        self.conv4 = ConvRefl(64, 128)
        self.conv5 = ConvRefl(128, 128)
        self.conv6 = ConvRefl(128, 128)
        self.conv7 = nn.Conv2d(128, out_channel, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) in [0, 1] -> (N, 32, 32, out_channel) f32."""
        dt = self.dtype
        x = conv(self.conv1, nchw(x), dt)
        x = leaky_relu(self.conv2(x, dt))
        x = leaky_relu(self.conv3(x, dt))
        x = F.max_pool2d(x, 2, 2)
        x = leaky_relu(self.conv4(x, dt))
        x = leaky_relu(self.conv5(x, dt))
        x = F.max_pool2d(x, 2, 2)
        x = leaky_relu(self.conv6(x, dt))
        x = adaptive_avg_pool2d_nchw(x, (self.pool_hw, self.pool_hw))
        x = leaky_relu(conv(self.conv7, x, dt))
        return nhwc(x).float()
