"""Appearance (style) encoder (``crnerf_tpu/models/appearance.py``
``AppearanceEncoder``, plain schedule): a small VGG-like conv stack over the
whole [0, 1] image with two 2x2 maxpools, an adaptive average pool to
32x32 and a 1x1 projection -> the (N, 32, 32, C) style embedding.

``Encoder3`` / ``Decoder3`` are the legacy linear-style-transfer pair of
the model zoo (same file, same names), on no path of the system (as in the
JAX package).
"""

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


class Encoder3(nn.Module):
    """The legacy VGG-style encoder: a 1x1 conv, two pairs of reflection-
    padded 3x3 convs each followed by a 2x2 max pool (floor: an odd
    trailing row or column is dropped), one more 3x3 conv. It computes at
    its parameters' dtype (fp32, as the JAX module; float64 after
    ``.double()``)."""

    def __init__(self, out_channel: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 3, 1)
        self.conv2 = ConvRefl(3, 64)
        self.conv3 = ConvRefl(64, 64)
        self.conv4 = ConvRefl(64, 128)
        self.conv5 = ConvRefl(128, 128)
        self.conv6 = ConvRefl(128, out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) -> (N, H // 2 // 2, W // 2 // 2, out_channel)."""
        dt = self.conv1.weight.dtype
        x = conv(self.conv1, nchw(x), dt)
        x = leaky_relu(self.conv2(x, dt))
        x = leaky_relu(self.conv3(x, dt))
        x = F.max_pool2d(x, 2, 2)
        x = leaky_relu(self.conv4(x, dt))
        x = leaky_relu(self.conv5(x, dt))
        x = F.max_pool2d(x, 2, 2)
        return nhwc(leaky_relu(self.conv6(x, dt)))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of NCHW (``jnp.repeat`` by 2 on H
    and W) as a broadcast view: its backward sums each 2x2 block in a
    fixed order (an ``index_select``, as ``repeat_interleave`` runs,
    would add with atomics on the card)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


class Decoder3(nn.Module):
    """The legacy decoder: reflection-padded 3x3 convs with ReLU around two
    nearest-neighbour 2x upsamples, the last conv linear. It computes at
    its parameters' dtype, as ``Encoder3``."""

    def __init__(self, in_channel: int = 64):
        super().__init__()
        self.conv7 = ConvRefl(in_channel, 128)
        self.conv8 = ConvRefl(128, 128)
        self.conv9 = ConvRefl(128, 64)
        self.conv10 = ConvRefl(64, 64)
        self.conv11 = ConvRefl(64, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, in_channel) -> (N, 4 H, 4 W, 3)."""
        dt = self.conv7.Conv_0.weight.dtype
        x = torch.relu(self.conv7(nchw(x), dt))
        x = _up2(x)
        x = torch.relu(self.conv8(x, dt))
        x = torch.relu(self.conv9(x, dt))
        x = _up2(x)
        x = torch.relu(self.conv10(x, dt))
        return nhwc(self.conv11(x, dt))
