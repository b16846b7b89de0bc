"""Shared building blocks (``crnerf_tpu/models/common.py``), only what the
serving path uses. Public functions take and return NHWC tensors, as the
JAX package's do, and are held to them by the tests; the modules, which run
NCHW between their layers, call the same torch operators directly.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel PReLU (torch ``nn.PReLU(C)`` semantics, init 0.25) on
    NCHW input; ``weight`` is the flax module's ``alpha``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[None, :, None, None] * x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: the slope is rounded to x's dtype first (a
    Python scalar takes the array's dtype in JAX), so at bf16 the product
    is bf16(0.2) * x, rounded once."""
    slope = float(torch.tensor(slope, dtype=x.dtype))
    return F.leaky_relu(x, negative_slope=slope)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """NHWC reflection padding of H and W (``nn.ReflectionPad2d``)."""
    return nhwc(F.pad(nchw(x), (pad, pad, pad, pad), mode="reflect"))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2), floor: an odd trailing row/column is dropped."""
    return nhwc(F.max_pool2d(nchw(x), 2, 2))


def avg_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1), count_include_pad=True."""
    return nhwc(F.avg_pool2d(nchw(x), 3, 2, 1, count_include_pad=True))


def _bin_matrix(size: int, out: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """(out, size): row i averages [floor(i*S/O), ceil((i+1)*S/O))."""
    m = torch.zeros((out, size), dtype=torch.float32)
    for i in range(out):
        s, e = (i * size) // out, -((-(i + 1) * size) // out)
        m[i, s:e] = 1.0 / (e - s)
    return m.to(dtype).float().to(device)


def adaptive_avg_pool2d_nchw(x: torch.Tensor,
                             out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` as the JAX package computes it: two
    contractions with bin-average matrices held at x's dtype (at bf16 a
    1/3 weight is bf16(1/3)), summed in fp32, cast back to x's dtype."""
    _, _, h, w = x.shape
    eh = _bin_matrix(h, out_hw[0], x.dtype, x.device)
    ew = _bin_matrix(w, out_hw[1], x.dtype, x.device)
    y = torch.einsum("oh,nchw->ncow", eh, x.float())
    return torch.einsum("pw,ncow->ncop", ew, y).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    return nhwc(adaptive_avg_pool2d_nchw(nchw(x), out_hw))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres, no antialiasing. Equal to
    ``jax.image.resize(method='bilinear')`` when upsampling (the only use on
    the serving path: CGNet's logits back to the input size); JAX
    antialiases when downsampling and this does not."""
    return nhwc(F.interpolate(nchw(x), size=tuple(out_hw), mode="bilinear",
                              align_corners=False, antialias=False))


def sample_bilinear_uv(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at normalized (v, u) coords (N, 2) in [0, 1)
    with half-pixel centres: the value interpolate-then-index gives at
    those pixels, without the full-resolution map."""
    h, w, _ = img.shape
    y = uv[:, 0] * h - 0.5
    x = uv[:, 1] * w - 0.5
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xx = torch.clamp(xx.to(torch.int64), 0, w - 1)
        return img[yy, xx]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def conv(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dt)`` on NCHW: input and kernel cast to dt, the
    product rounded to dt, then the bias added at dt (two roundings, as in
    flax; a fused bias would round once)."""
    y = F.conv2d(x.to(dt), layer.weight.to(dt), None, layer.stride,
                 layer.padding, layer.dilation, layer.groups)
    return y if layer.bias is None else y + layer.bias.to(dt)[:, None, None]


def conv1x1(layer: nn.Conv2d, x: torch.Tensor,
            dt: torch.dtype) -> torch.Tensor:
    """A 1x1 ``nn.Conv(dtype=dt)`` on NHWC, as the matrix product it is,
    with the bias added after the rounding as in ``conv``."""
    y = F.linear(x.to(dt), layer.weight[:, :, 0, 0].to(dt))
    return y if layer.bias is None else y + layer.bias.to(dt)


class ConvRefl(nn.Module):
    """Reflection pad + VALID conv (flax ``ConvRefl``: child ``Conv_0``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3):
        super().__init__()
        self.pad = (kernel - 1) // 2
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """NCHW in, NCHW out."""
        if self.pad:
            p = self.pad
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return conv(self.Conv_0, x, dt)
