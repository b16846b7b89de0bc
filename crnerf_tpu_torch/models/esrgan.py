"""ESRGAN-style RRDB decoder (``crnerf_tpu/models/esrgan.py``): 1x1-conv
dense residual blocks with 0.2 residual scaling, output (tanh + 1) / 2. An
alternative feature-map-to-RGB decoder of the reference's model zoo that no
configuration uses; NHWC in and out, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from crnerf_tpu_torch.models.common import conv1x1, leaky_relu


class DenseResidualBlock(nn.Module):
    def __init__(self, filters: int, res_scale: float = 0.2):
        super().__init__()
        self.res_scale = res_scale
        for i in range(5):
            self.add_module(f"b{i + 1}",
                            nn.Conv2d(filters * (i + 1), filters, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(5):
            out = conv1x1(getattr(self, f"b{i + 1}"), inputs, torch.float32)
            if i < 4:
                out = leaky_relu(out)
            inputs = torch.cat([inputs, out], -1)
        return out * self.res_scale + x


class ResidualInResidualDenseBlock(nn.Module):
    def __init__(self, filters: int, res_scale: float = 0.2):
        super().__init__()
        self.res_scale = res_scale
        for i in range(3):
            self.add_module(f"dense_{i}", DenseResidualBlock(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = getattr(self, f"dense_{i}")(h)
        return h * self.res_scale + x


class RRDBNet(nn.Module):
    """The reference's ``GeneratorRRDB``: (N, H, W, channels) ->
    (N, H, W, 3) in [0, 1]."""

    def __init__(self, channels: int = 64, filters: int = 64,
                 num_res_blocks: int = 2):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.conv1 = nn.Conv2d(channels, filters, 1)
        for i in range(num_res_blocks):
            self.add_module(f"rrdb_{i}",
                            ResidualInResidualDenseBlock(filters))
        self.conv2 = nn.Conv2d(filters, filters, 1)
        self.conv3_0 = nn.Conv2d(filters, filters, 1)
        self.conv3_1 = nn.Conv2d(filters, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        out1 = conv1x1(self.conv1, x, f32)
        h = out1
        for i in range(self.num_res_blocks):
            h = getattr(self, f"rrdb_{i}")(h)
        h = out1 + conv1x1(self.conv2, h, f32)
        h = leaky_relu(conv1x1(self.conv3_0, h, f32))
        h = conv1x1(self.conv3_1, h, f32)
        return (torch.tanh(h) + 1.0) / 2.0
