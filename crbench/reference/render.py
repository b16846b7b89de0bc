"""Samples along rays, the two passes and alpha compositing of the plain
reference."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from crbench.reference.model import FP32, Quant, Weights, nerf, posenc

DELTA_INF = 1e2


def stratified(near, far, n: int):
    """(N, 1) near and far -> (N, n) evenly spaced in depth."""
    t = torch.arange(n, dtype=torch.float32, device=near.device) / (n - 1)
    return near * (1.0 - t) + far * t


def perturb(z, u):
    """Each sample moved inside its mid-point interval by u in [0, 1)."""
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    upper = torch.cat([mid, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mid], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, n: int, e: Optional[torch.Tensor] = None,
               eps: float = 1e-5):
    """Inverse-CDF samples: at linspace(0, 1) (``e`` None), or at the
    sorted uniforms made from the exponential spacings ``e`` (N, n + 1)."""
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if e is None:
        u = (torch.arange(n, dtype=cdf.dtype, device=cdf.device)
             / (n - 1)).expand(cdf.shape[0], n)
    else:
        cs = torch.cumsum(e, -1)
        u = cs[:, :-1] / cs[:, -1:]
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=weights.shape[1])
    cb, ca = cdf.gather(1, below), cdf.gather(1, above)
    bb, ba = bins.gather(1, below), bins.gather(1, above)
    denom = ca - cb
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bb + (u - cb) / denom * (ba - bb)


def composite(feat, sigma, z, noise):
    """-> (weights (N, S), feature map (N, C))."""
    delta = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], DELTA_INF)], -1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sigma + noise))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1]], -1), -1)
    w = alpha * trans
    return w, torch.einsum("ns,nsc->nc", w, feat)


def run_pass(W: Weights, which: str, rays, z, noise, cfg: Dict,
             q: Quant = FP32):
    o, d = rays[:, 0:3], rays[:, 3:6]
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    xyz = posenc(pts, cfg["N_emb_xyz"])
    dirs = posenc(d, cfg["N_emb_dir"])[:, None, :].expand(
        *z.shape, 3 + 6 * cfg["N_emb_dir"])
    feat, sigma = nerf(W, which, xyz, dirs, cfg["netdepth"], (4,), q)
    return composite(feat, sigma, z, noise)


def render(W: Weights, rays, cfg: Dict, q: Quant = FP32,
           draws: Optional[Dict[str, torch.Tensor]] = None):
    """Coarse and fine features (N, C) of ``rays`` (N, 8). With ``draws``
    (training: ``z_u``, ``noise_coarse``, ``noise_fine``, ``pdf_e`` a ray)
    the samples are perturbed, sigma takes the noise and the fine samples
    are drawn; without, the render is deterministic (inference)."""
    near, far = rays[:, 6:7], rays[:, 7:8]
    ns, ni = cfg["N_samples"], cfg["N_importance"]
    z = stratified(near, far, ns)
    zero = torch.zeros_like
    if draws is not None:
        z = perturb(z, draws["z_u"])
    noise_c = draws["noise_coarse"] if draws is not None else zero(z)
    w_c, f_c = run_pass(W, "nerf_coarse", rays, z, noise_c, cfg, q)
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_f = sample_pdf(mid, w_c.detach()[:, 1:-1], ni,
                     draws["pdf_e"] if draws is not None else None)
    z_all = torch.sort(torch.cat([z, z_f.detach()], -1), -1).values
    noise_f = draws["noise_fine"] if draws is not None else zero(z_all)
    _, f_f = run_pass(W, "nerf_fine", rays, z_all, noise_f, cfg, q)
    return f_c, f_f
