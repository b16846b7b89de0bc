"""The NeRF-W-era modules of the reference's model zoo
(``crnerf_tpu/models/networks.py``): ``EAttr``, an attribute encoder, and
``ImplicitMask``, the MLP mask that CGNet superseded. Neither is used by
any configuration; NHWC in, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from crnerf_tpu_torch.models.common import conv, nchw, reflect_pad_nchw


class EAttr(nn.Module):
    """A reflection-padded conv pyramid (7x7, then four 4x4 of stride 2),
    a global average pool and a 1x1 conv -> (N, output_nc). The flax
    module infers its input channels; here they are ``input_nc``."""

    def __init__(self, input_nc: int = 3, output_nc: int = 8):
        super().__init__()
        dim = 64
        chans = [input_nc, dim, dim * 2, dim * 4, dim * 4, dim * 4]
        self.Conv_0 = nn.Conv2d(input_nc, dim, 7)
        for i in range(1, 5):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 4,
                                                   stride=2))
        self.Conv_5 = nn.Conv2d(dim * 4, output_nc, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        x = torch.relu(conv(self.Conv_0, reflect_pad_nchw(nchw(x), 3), f32))
        for i in range(1, 5):
            x = torch.relu(conv(getattr(self, f"Conv_{i}"),
                                reflect_pad_nchw(x, 1), f32))
        x = conv(self.Conv_5, x.mean(dim=(2, 3), keepdim=True), f32)
        return x.reshape(x.shape[0], -1)


class ImplicitMask(nn.Module):
    """A 4 x ``width`` ReLU MLP and a sigmoid over (..., in_features)
    inputs (the latent and the direction embedding side by side)."""

    def __init__(self, in_features: int, width: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"fc{i}", nn.Linear(
                in_features if i == 0 else width, width))
        self.out = nn.Linear(width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return torch.sigmoid(self.out(x))
