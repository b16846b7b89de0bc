"""Positional (frequency) encoding (``crnerf_tpu/core/encoding.py``).

x -> [x, sin(f_0 x), cos(f_0 x), ..., sin(f_{N-1} x), cos(f_{N-1} x)] with
logscale frequencies f_k = 2^linspace(0, max_logscale, N), interleaved per
frequency exactly as the reference and the JAX package lay it out.
"""

from __future__ import annotations

import numpy as np
import torch


def posenc_dims(n_freqs: int, in_dim: int = 3) -> int:
    return in_dim * (1 + 2 * n_freqs)


def frequencies(max_logscale: int, n_freqs: int, logscale: bool = True):
    if logscale:
        return 2.0 ** np.linspace(0.0, float(max_logscale), n_freqs)
    return np.linspace(1.0, 2.0 ** max_logscale, n_freqs)


def posenc(x: torch.Tensor, n_freqs: int, max_logscale: int | None = None,
           logscale: bool = True) -> torch.Tensor:
    """x (..., D) -> (..., D*(1+2*n_freqs)), layout
    [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]."""
    if max_logscale is None:
        max_logscale = n_freqs - 1
    freqs = torch.as_tensor(
        frequencies(max_logscale, n_freqs, logscale), dtype=x.dtype,
        device=x.device,
    )
    xb = x[..., None, :] * freqs[:, None]                 # (..., F, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)
