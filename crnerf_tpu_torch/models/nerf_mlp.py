"""NeRF MLP (``crnerf_tpu/models/nerf_mlp.py`` ``NerfMLP``).

8x256 ReLU trunk over the positional-encoded xyz with the raw encode fed
back in at layer 4 (``cat([x_emb, h])``, x_emb first), an fp32 Softplus
sigma head, and a direction branch Linear(W+27 -> W/2)+ReLU,
Linear(W/2 -> C)+Sigmoid that emits the cross-ray feature. Layer names
match the flax module so the weight bridge is a rename.

This module holds the parameters and is the plain per-point reference; the
renderer evaluates it through ``ops.fused_render`` (one kernel per pass).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)) (no threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), each step rounded to x's
    dtype (at bf16 this differs from a once-rounded ``torch.sigmoid`` by
    one ulp in about a third of the values)."""
    return 1.0 / (1.0 + torch.exp(-x))


def dense(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype):
    """flax ``nn.Dense(dtype=dt)``: input and kernel cast to dt, the product
    rounded to dt, then the bias added at dt."""
    return F.linear(x.to(dt), layer.weight.to(dt)) + layer.bias.to(dt)


def split_dense(layer: nn.Linear, a: torch.Tensor, b: torch.Tensor,
                dt: torch.dtype):
    """Dense over cat([a, b]) without the concat: a @ K[:da] + b @ K[da:]."""
    da = a.shape[-1]
    w = layer.weight.to(dt)
    out = F.linear(a.to(dt), w[:, :da]) + F.linear(b.to(dt), w[:, da:])
    return out + layer.bias.to(dt)


class NerfMLP(nn.Module):
    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Tuple[int, ...] = (4,), in_channels_xyz: int = 93,
                 in_channels_dir: int = 27, out_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.in_channels_xyz = in_channels_xyz
        self.in_channels_dir = in_channels_dir
        self.out_dim = out_dim
        self.compute_dtype = compute_dtype
        for i in range(depth):
            d_in = (in_channels_xyz if i == 0
                    else width + (in_channels_xyz if i in self.skips else 0))
            self.add_module(f"xyz_encoding_{i + 1}", nn.Linear(d_in, width))
        self.sigma = nn.Linear(width, 1)
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Linear(width + in_channels_dir, width // 2)
        self.feature = nn.Linear(width // 2, out_dim)

    def trunk(self, i: int) -> nn.Linear:
        return getattr(self, f"xyz_encoding_{i + 1}")

    def forward(self, xyz_emb: torch.Tensor,
                dir_emb: torch.Tensor) -> torch.Tensor:
        """xyz_emb (..., 93), dir_emb (..., 27) ->
        (..., out_dim+1) = [sigmoid features, softplus sigma]."""
        dt = self.compute_dtype
        x = xyz_emb.to(dt)
        h = x
        for i in range(self.depth):
            if i in self.skips:
                h = split_dense(self.trunk(i), x, h, dt)
            else:
                h = dense(self.trunk(i), h, dt)
            h = torch.relu(h)
        sigma = softplus(F.linear(h.float(), self.sigma.weight,
                                  self.sigma.bias))
        h_final = dense(self.xyz_encoding_final, h, dt)
        d = torch.relu(split_dense(self.dir_encoding, h_final, dir_emb, dt))
        feat = sigmoid(dense(self.feature, d, dt))
        return torch.cat([feat.float(), sigma], -1)
