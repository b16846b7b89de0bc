"""Alpha compositing of per-sample features along rays
(``crnerf_tpu/core/compositing.py``).

deltas from consecutive z (last = DELTA_INF = 1e2), alpha =
1 - exp(-delta * relu(sigma + noise)), transmittance = exclusive cumprod of
(1 - alpha), weights = alpha * transmittance; outputs are the weighted
feature sum and the expected depth.
"""

from __future__ import annotations

from typing import Optional

import torch

DELTA_INF = 1e2


def compute_alphas(sigmas: torch.Tensor, z_vals: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigmas, z_vals, noise: (N, S) -> alphas (N, S)."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(z_vals[:, :1], DELTA_INF)],
                       -1)
    if noise is not None:
        sigmas = sigmas + noise
    return 1.0 - torch.exp(-deltas * torch.relu(sigmas))


def weights_from_alphas(alphas: torch.Tensor) -> torch.Tensor:
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas[:, :-1]], -1)
    return alphas * torch.cumprod(shifted, -1)


def composite(features: torch.Tensor, sigmas: torch.Tensor,
              z_vals: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """features (N, S, C), sigmas (N, S), z_vals (N, S) ->
    (weights (N, S), feature_map (N, C), depth (N,))."""
    weights = weights_from_alphas(compute_alphas(sigmas, z_vals, noise))
    fmap = torch.einsum("ns,nsc->nc", weights, features.float())
    depth = torch.sum(weights * z_vals, -1)
    return weights, fmap.to(features.dtype), depth
