"""NeRF MLPs (``crnerf_tpu/models/nerf_mlp.py``): ``NerfMLP``, and the
reference's two unused variants ``NerfWMLP`` and ``NerfTanhMLP``.

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

from crnerf_tpu_torch.models.common import leaky_relu
from crnerf_tpu_torch.parallel import tp


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
    rounded to dt, then the bias added at dt (the product through the
    model split, ``parallel.tp.columns``)."""
    y = tp.columns(lambda w, x: F.linear(x.to(dt), w.to(dt)), layer.weight,
                   x)
    return y + layer.bias.to(dt)


def split_dense(layer: nn.Linear, a: torch.Tensor, b: torch.Tensor,
                dt: torch.dtype):
    """Dense over cat([a, b]) without the concat: a @ K[:da] + b @ K[da:]."""
    da = a.shape[-1]

    def product(w, a, b):
        w = w.to(dt)
        return F.linear(a.to(dt), w[:, :da]) + F.linear(b.to(dt), w[:, da:])

    return tp.columns(product, layer.weight, a, b) + layer.bias.to(dt)


def sigma_head(layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    """The fp32 Softplus sigma head on unrounded weights, its bias fused
    (through the model split: the rule leaves a head of one output whole)."""
    return softplus(tp.columns(
        lambda w, h: F.linear(h.float(), w, tp.local_rows(layer.bias, w)),
        layer.weight, h))


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
        sigma = sigma_head(self.sigma, h)
        h_final = dense(self.xyz_encoding_final, h, dt)
        d = torch.relu(split_dense(self.dir_encoding, h_final, dir_emb, dt))
        feat = sigmoid(dense(self.feature, d, dt))
        return torch.cat([feat.float(), sigma], -1)


class NerfWMLP(nn.Module):
    """The NeRF-W variant (``crnerf_tpu/models/nerf_mlp.py`` ``NerfWMLP``):
    a ReLU trunk with the skip, the appearance embedding fed to the
    direction branch, and with ``a_emb_random`` a second pass of that
    branch on detached inputs. Returns the static rgb, or both side by
    side. Dead code in the reference; no system path builds it."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Tuple[int, ...] = (4,), in_channels_xyz: int = 93,
                 in_channels_dir: int = 27, in_channels_a: int = 48,
                 out_dim: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.skips = depth, tuple(skips)
        self.compute_dtype = compute_dtype
        for i in range(depth):
            d_in = (in_channels_xyz if i == 0
                    else width + (in_channels_xyz if i in self.skips else 0))
            self.add_module(f"xyz_encoding_{i + 1}", nn.Linear(d_in, width))
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Linear(
            width + in_channels_dir + in_channels_a, width // 2)
        self.rgb = nn.Linear(width // 2, out_dim)

    def _dir_branch(self, d_in: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        d = torch.relu(dense(self.dir_encoding, d_in, dt))
        return sigmoid(dense(self.rgb, d, dt))

    def forward(self, xyz_emb: torch.Tensor, dir_emb: torch.Tensor,
                a_emb: torch.Tensor, a_emb_random=None) -> torch.Tensor:
        dt = self.compute_dtype
        x = xyz_emb.to(dt)
        h = x
        for i in range(self.depth):
            if i in self.skips:
                h = torch.cat([x, h], -1)
            h = torch.relu(dense(getattr(self, f"xyz_encoding_{i + 1}"), h,
                                 dt))
        h_final = dense(self.xyz_encoding_final, h, dt)
        ins = [h_final, dir_emb.to(dt), a_emb.to(dt)]
        static = self._dir_branch(torch.cat(ins, -1))
        if a_emb_random is None:
            return static
        ins_r = [t.detach() for t in ins[:2]] + [a_emb_random.to(dt).detach()]
        return torch.cat([static, self._dir_branch(torch.cat(ins_r, -1))], -1)


class NerfTanhMLP(nn.Module):
    """``NeRF_sigma_tanh`` (``crnerf_tpu/models/nerf_mlp.py``
    ``NerfTanhMLP``): a LeakyReLU(0.2) trunk with the skip, the fp32
    softplus sigma head, and a direction branch with LeakyReLU(0.2) and a
    tanh feature head -> [features, sigma]. Dead code in the reference;
    no system path builds it."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Tuple[int, ...] = (4,), in_channels_xyz: int = 93,
                 in_channels_dir: int = 27, out_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.skips = depth, tuple(skips)
        self.compute_dtype = compute_dtype
        for i in range(depth):
            d_in = (in_channels_xyz if i == 0
                    else width + (in_channels_xyz if i in self.skips else 0))
            self.add_module(f"xyz_encoding_{i + 1}", nn.Linear(d_in, width))
        self.sigma = nn.Linear(width, 1)
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Linear(width + in_channels_dir, width // 2)
        self.feature = nn.Linear(width // 2, out_dim)

    def forward(self, xyz_emb: torch.Tensor, dir_emb: torch.Tensor,
                sigma_only: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        x = xyz_emb.to(dt)
        h = x
        for i in range(self.depth):
            if i in self.skips:
                h = torch.cat([x, h], -1)
            h = leaky_relu(dense(getattr(self, f"xyz_encoding_{i + 1}"), h,
                                 dt))
        sigma = sigma_head(self.sigma, h)
        if sigma_only:
            return sigma
        h_final = dense(self.xyz_encoding_final, h, dt)
        d = torch.cat([h_final, dir_emb.to(dt)], -1)
        d = leaky_relu(dense(self.dir_encoding, d, dt))
        feat = torch.tanh(dense(self.feature, d, dt))
        return torch.cat([feat.float(), sigma], -1)
