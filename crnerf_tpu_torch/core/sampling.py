"""Depth-sample generation along rays (``crnerf_tpu/core/sampling.py``).

Stratified z values and inverse-CDF resampling (``sample_pdf``) with
``torch.searchsorted``. The JAX package's onehot,
maskreduce and bitonic-merge forms are TPU gather workarounds; the values
they produce are the ones computed here.
"""

from __future__ import annotations

from typing import Optional

import torch


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """linspace(0, 1, n) as jnp.linspace forms it: i / (n - 1), each
    rounded once (torch.linspace fills from both ends)."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.arange(n, dtype=dtype, device=device) / (n - 1)


def stratified_zvals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                     use_disp: bool = False) -> torch.Tensor:
    """(N, 1) near/far -> (N, n_samples), linear in depth or disparity."""
    z_steps = linspace01(n_samples, near.dtype, near.device)
    if not use_disp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = True, eps: float = 1e-5,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins (N, B+1) interval edges, weights (N, B)
    -> (N, n_importance) at the quantiles ``u`` (N, n_importance), or at
    linspace(0, 1) when ``det``. Inference is deterministic; a stochastic
    caller passes its own sorted draws as ``u``."""
    n_rays, n_bins = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)   # (N, B+1)
    if u is None:
        if not det:
            raise ValueError("sample_pdf(det=False) needs the draws u")
        u = linspace01(n_importance, cdf.dtype, cdf.device).expand(
            n_rays, n_importance)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_bins)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_sorted_zvals(z_coarse: torch.Tensor,
                       z_fine: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse and fine samples."""
    return torch.sort(torch.cat([z_coarse, z_fine], -1), dim=-1).values
