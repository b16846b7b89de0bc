"""Volumetric renderer of the serving path (``crnerf_tpu/render/renderer.py``
``render_rays`` / ``render_rays_tiled`` at inference).

Coarse pass -> inverse-CDF resampling from the coarse weights -> fine pass
over the sorted union of samples. Each pass is one fused-render call
(``ops.fused_render``: the CUDA kernel on the card, its plain version on
the CPU). Inference is deterministic: no z perturbation, no sigma noise,
``sample_pdf(det=True)``. The JAX package's ``lax.map`` over ray tiles is a
Python loop over ``chunk``-ray tiles here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from crnerf_tpu_torch.core.sampling import (
    merge_sorted_zvals,
    sample_pdf,
    stratified_zvals,
)
from crnerf_tpu_torch.ops.fused_render import (
    KernelWeights,
    fused_render_apply,
)


def _pass(kw: KernelWeights, rays_o, rays_d, z, exact_encode: bool):
    blk, w = fused_render_apply(kw, rays_o, rays_d, z, torch.zeros_like(z),
                                exact_encode)
    c = kw.dims["C"]
    return w, blk[:, :c], blk[:, c]


@torch.no_grad()
def render_rays(
    coarse: KernelWeights,
    fine: Optional[KernelWeights],
    rays: torch.Tensor,             # (N, 8): o, d, near, far
    *,
    n_samples: int = 64,
    n_importance: int = 64,
    use_disp: bool = False,
    exact_encode: bool = True,
) -> Dict[str, torch.Tensor]:
    """-> {weights,feature,depth}_coarse and, with a fine pass,
    {weights,feature,depth}_fine and z_fine. ``coarse``/``fine`` come
    from ``prepare_kernel_weights``."""
    rays_o = rays[:, 0:3].contiguous()
    rays_d = rays[:, 3:6].contiguous()
    near, far = rays[:, 6:7], rays[:, 7:8]
    z_vals = stratified_zvals(near, far, n_samples, use_disp).contiguous()
    w_c, fmap_c, depth_c = _pass(coarse, rays_o, rays_d, z_vals,
                                 exact_encode)
    out = {"weights_coarse": w_c, "feature_coarse": fmap_c,
           "depth_coarse": depth_c}
    if n_importance <= 0 or fine is None:
        return out
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, w_c[:, 1:-1], n_importance, det=True)
    z_all = merge_sorted_zvals(z_vals, z_fine).contiguous()
    w_f, fmap_f, depth_f = _pass(fine, rays_o, rays_d, z_all, exact_encode)
    out.update(weights_fine=w_f, feature_fine=fmap_f, depth_fine=depth_f,
               z_fine=z_all)
    return out


@torch.no_grad()
def render_rays_tiled(coarse: KernelWeights, fine: Optional[KernelWeights],
                      rays: torch.Tensor, *, tile: int = 8192,
                      **kw) -> Dict[str, torch.Tensor]:
    """``render_rays`` over ``tile``-ray slices, concatenated: the tile
    bounds the per-point memory of the plain version and the kernel's
    grid, nothing else."""
    parts = [render_rays(coarse, fine, rays[i:i + tile], **kw)
             for i in range(0, rays.shape[0], tile)]
    return {k: torch.cat([p[k] for p in parts], 0) for k in parts[0]}
