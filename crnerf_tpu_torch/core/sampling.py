"""Depth-sample generation along rays (``crnerf_tpu/core/sampling.py``).

Stratified z values, their training-time perturbation, and inverse-CDF
resampling (``sample_pdf``) with ``torch.searchsorted``. The JAX package's
onehot, maskreduce and bitonic-merge forms are TPU gather workarounds; the
values they produce are the ones computed here. Every random draw comes
from an explicit ``torch.Generator`` or is passed in, so a test can hand
both packages the same numbers.
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


def perturb_zvals(z_vals: torch.Tensor, perturb: float,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Jitter samples inside their mid-point intervals by ``perturb * u``,
    u ~ U[0, 1) of z's shape: given, or drawn from ``generator``."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    upper = torch.cat([z_mid, z_vals[:, -1:]], -1)
    lower = torch.cat([z_vals[:, :1], z_mid], -1)
    if u is None:
        u = torch.rand(z_vals.shape, dtype=z_vals.dtype,
                       device=z_vals.device, generator=generator)
    return lower + (upper - lower) * (perturb * u)


def sorted_uniforms(e: torch.Tensor) -> torch.Tensor:
    """Exponential draws e (N, I+1) -> (N, I) ascending values distributed
    as the order statistics of I iid U[0, 1) draws: the normalised
    spacings cumsum(e)[:-1] / cumsum(e)[-1]. Ascending u makes z_fine
    ascending."""
    cs = torch.cumsum(e, -1)
    return cs[:, :-1] / cs[:, -1:]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = True, eps: float = 1e-5,
               u: Optional[torch.Tensor] = None,
               e: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins (N, B+1) interval edges, weights (N, B)
    -> (N, n_importance): at linspace(0, 1) when ``det`` (inference), else
    at the ascending quantiles ``u`` (N, n_importance), or at sorted
    uniform draws made from the exponential spacings ``e``
    (N, n_importance + 1), given or drawn from ``generator``."""
    n_rays, n_bins = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)   # (N, B+1)
    if det:
        u = linspace01(n_importance, cdf.dtype, cdf.device).expand(
            n_rays, n_importance)
    elif u is None:
        if e is None:
            if generator is None:
                raise ValueError("sample_pdf(det=False) needs the draws u "
                                 "or e, or a generator")
            e = torch.empty((n_rays, n_importance + 1), dtype=cdf.dtype,
                            device=cdf.device).exponential_(
                                generator=generator)
        u = sorted_uniforms(e)
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
