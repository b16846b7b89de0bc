"""Volumetric renderer (``crnerf_tpu/render/renderer.py`` ``render_rays`` /
``render_rays_tiled``), inference and training.

Coarse pass -> inverse-CDF resampling from the coarse weights -> fine pass
over the sorted union of samples. A pass takes one of the three routes of
the JAX ``run_pass``:

  full    one fused-render call (``ops.fused_render``: encode, MLP and
          compositing in one kernel; only per-ray results leave it);
  mlp     one fused-MLP call (``ops.fused_mlp``: encode and MLP in one
          kernel, features and sigma written per point), then
          ``core.compositing.composite`` in plain PyTorch, under autograd in
          training: the route for anything that needs per-point outputs;
  module  the ``NerfMLP`` module on the exact encode, under autograd (with
          ``torch.utils.checkpoint`` for ``remat``), then ``composite``.

The first two run the CUDA kernels on the card and their plain versions on
the CPU. What selects the route is what the caller hands in (inference:
``KernelWeights``, ``MlpKernelWeights`` or the modules; training: live
``MlpParams`` with ``full=`` or the modules).

Inference (``render_rays``) is deterministic: no z perturbation, no sigma
noise, ``sample_pdf(det=True)``; it takes weights laid out once, which
carry no gradient (its callers run under ``torch.no_grad``). Training
(``render_rays_train``) perturbs the coarse samples, adds
``noise_std * N(0, 1)`` to sigma (drawn here and fed to the kernel, so
training and inference share one kernel body), resamples stochastically
from the detached coarse weights, and is differentiable in the MLP weights
only: rays, z and noise are detached before each fused call, as in the JAX
package. It takes the live parameters. Every random input is drawn from a
``torch.Generator`` or passed in through ``draws``, the same draws on every
route. With ``pertube_cord`` every sample point of a pass is moved by
``1e-5 * U[0, 1)``: the full route then hands the kernels one coordinate
per point (xyz-in) and its backward recomputes, as it does with
``stash=False``; the other two routes take a coordinate per point anyway.

The JAX package's ``lax.map`` over ray tiles is a Python loop over
``chunk``-ray tiles here.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from crnerf_tpu_torch.core.compositing import composite
from crnerf_tpu_torch.core.encoding import posenc
from crnerf_tpu_torch.core.sampling import (
    merge_sorted_zvals,
    perturb_zvals,
    sample_pdf,
    stratified_zvals,
)
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops.fused_mlp import (
    MlpKernelWeights,
    fused_mlp_apply,
    fused_mlp_train,
)
from crnerf_tpu_torch.ops.fused_render import (
    KernelWeights,
    MlpParams,
    fused_render_apply,
    fused_render_train,
)


def _noise(shape, noise_std: float, given, device, generator):
    if given is not None:
        return given.to(torch.float32).contiguous()
    if noise_std <= 0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return noise_std * torch.randn(shape, dtype=torch.float32, device=device,
                                   generator=generator)


PERTUBE_SCALE = 1e-5    # size of the coordinate jitter


def _render(run_pass, rays: torch.Tensor, n_samples: int, n_importance: int,
            use_disp: bool, perturb: float = 0.0, noise_std: float = 0.0,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None,
            pertube_cord: bool = False) -> Dict[str, torch.Tensor]:
    """The two-pass skeleton. ``run_pass(which, rays_o, rays_d, z, noise,
    xyz)`` -> (weights, feature map, depth) runs the coarse (``which`` 0) or
    fine (1) MLP over the samples and composites; ``n_importance`` 0 stops
    after the coarse pass. ``perturb`` 0 and ``noise_std`` 0 give the
    deterministic render. ``xyz`` is None unless ``pertube_cord``: then
    (N, S, 3), the pass's points o + d*z plus the jitter, both in float32
    and in this order."""
    draws = draws or {}
    rays = rays.detach()
    rays_o = rays[:, 0:3].contiguous()
    rays_d = rays[:, 3:6].contiguous()
    near, far = rays[:, 6:7], rays[:, 7:8]

    def outputs(which: int, z, noise_key: str, tag: str):
        noise = _noise(z.shape, noise_std, draws.get(noise_key), rays.device,
                       generator)
        xyz = None
        if pertube_cord:
            u = draws.get(f"pertube_{tag}")
            if u is None:
                u = torch.rand((*z.shape, 3), dtype=torch.float32,
                               device=rays.device, generator=generator)
            xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
                   + PERTUBE_SCALE * u.to(torch.float32))
        w, fmap, depth = run_pass(which, rays_o, rays_d, z, noise, xyz)
        return {f"weights_{tag}": w, f"feature_{tag}": fmap,
                f"depth_{tag}": depth}

    z_vals = stratified_zvals(near, far, n_samples, use_disp)
    if perturb > 0:
        z_vals = perturb_zvals(z_vals, perturb, draws.get("z_u"), generator)
    z_vals = z_vals.contiguous()
    out = outputs(0, z_vals, "noise_coarse", "coarse")
    if n_importance <= 0:
        return out
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, out["weights_coarse"].detach()[:, 1:-1],
                        n_importance, det=perturb == 0, e=draws.get("pdf_e"),
                        generator=generator)
    z_all = merge_sorted_zvals(z_vals, z_fine).contiguous()
    out.update(outputs(1, z_all, "noise_fine", "fine"), z_fine=z_all)
    return out


def _split_block(blk: torch.Tensor, w: torch.Tensor, c: int):
    """The fused render's (ray block, weights) -> (weights, fmap, depth)."""
    return w, blk[:, :c], blk[:, c]


def _points(rays_o, rays_d, z, xyz):
    """The pass's sample points (N, S, 3): ``xyz`` where the caller
    jittered them, else o + d*z."""
    if xyz is not None:
        return xyz
    return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]


def _module_points(mlp: NerfMLP, pts: torch.Tensor, rays_d: torch.Tensor,
                   remat: bool):
    """The ``NerfMLP`` module over (N, S, 3) points with one direction per
    ray, on the exact encode -> (features (N, S, C), sigma (N, S)). With
    ``remat`` (and a gradient to keep) the activations are recomputed in
    the backward instead of kept."""
    n, s, _ = pts.shape
    dir_emb = posenc(rays_d, (mlp.in_channels_dir - 3) // 6)

    def run(p):
        xyz_emb = posenc(p, (mlp.in_channels_xyz - 3) // 6)
        d = dir_emb[:, None, :].expand(n, s, dir_emb.shape[-1])
        return mlp(xyz_emb, d)

    if remat and torch.is_grad_enabled():
        out = checkpoint(run, pts, use_reentrant=False)
    else:
        out = run(pts)
    return out[..., :-1], out[..., -1]


Weights = Union[KernelWeights, MlpKernelWeights, NerfMLP]


def render_rays(
    coarse: Weights,
    fine: Optional[Weights],
    rays: torch.Tensor,             # (N, 8): o, d, near, far
    *,
    n_samples: int = 64,
    n_importance: int = 64,
    use_disp: bool = False,
    exact_encode: bool = True,
) -> Dict[str, torch.Tensor]:
    """-> {weights,feature,depth}_coarse and, with a fine pass,
    {weights,feature,depth}_fine and z_fine. ``coarse``/``fine`` select
    the route: ``prepare_kernel_weights``' layout the full one,
    ``prepare_mlp_weights``' the fused MLP + ``composite``, the ``NerfMLP``
    modules themselves the module route (which always encodes exactly)."""
    def run_pass(which, rays_o, rays_d, z, noise, xyz):
        kw = (coarse, fine)[which]
        if isinstance(kw, KernelWeights):
            return _split_block(*fused_render_apply(
                kw, rays_o, rays_d, z, noise, exact_encode), kw.dims["C"])
        n, s = z.shape
        pts = _points(rays_o, rays_d, z, xyz)
        if isinstance(kw, MlpKernelWeights):
            feat, sigma = fused_mlp_apply(kw, pts.reshape(n * s, 3), rays_d,
                                          exact_encode, dir_rep=s)
            feat, sigma = feat.reshape(n, s, -1), sigma.reshape(n, s)
        else:
            feat, sigma = _module_points(kw, pts, rays_d, remat=False)
        return composite(feat, sigma, z, noise)

    return _render(run_pass, rays, n_samples,
                   n_importance if fine is not None else 0, use_disp)


def render_rays_tiled(coarse: Weights, fine: Optional[Weights],
                      rays: torch.Tensor, *, tile: int = 8192,
                      **kw) -> Dict[str, torch.Tensor]:
    """``render_rays`` over ``tile``-ray slices, concatenated: the tile
    bounds the per-point memory of the plain version and the kernel's
    grid, nothing else."""
    parts = [render_rays(coarse, fine, rays[i:i + tile], **kw)
             for i in range(0, rays.shape[0], tile)]
    return {k: torch.cat([p[k] for p in parts], 0) for k in parts[0]}


def render_rays_train(
    coarse: Union[MlpParams, NerfMLP],
    fine: Optional[Union[MlpParams, NerfMLP]],
    rays: torch.Tensor,             # (N, 8): o, d, near, far
    *,
    n_samples: int = 64,
    n_importance: int = 64,
    n_emb_xyz: int = 15,
    n_emb_dir: int = 4,
    use_disp: bool = False,
    perturb: float = 1.0,
    noise_std: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    exact_encode: bool = True,
    skips=(4,),
    pertube_cord: bool = False,
    stash: bool = True,
    full: bool = True,
    remat: bool = True,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The training half of ``render_rays``: same keys as the inference
    result. ``coarse``/``fine`` are live parameter views
    (``mlp_params_from_module(m, detach=False)``) for the two fused routes,
    ``full`` (the JAX package's ``pallas_render``) choosing between the
    fused render and the fused MLP + ``composite``; or the ``NerfMLP``
    modules for the module route, with ``remat``. ``draws`` injects any of
    the random inputs in place of the generator's: ``z_u`` (N, n_samples)
    uniforms of the perturbation, ``noise_coarse`` (N, n_samples) and
    ``noise_fine`` (N, n_samples + n_importance) sigma noise already scaled
    by ``noise_std``, ``pdf_e`` (N, n_importance + 1) exponential
    spacings, and with ``pertube_cord`` the uniforms of the coordinate
    jitter ``pertube_coarse`` (N, n_samples, 3) and ``pertube_fine``
    (N, n_samples + n_importance, 3).

    ``stash`` (the JAX package's ``pallas_stash``, full route only): the
    forward of each pass keeps its activation stash for the backward.
    False, or ``pertube_cord`` (as in the JAX package, where only the
    rays-in kernel has a stash): nothing is kept and the backward
    recomputes. The fused MLP's backward always recomputes."""
    opts = dict(n_emb_xyz=n_emb_xyz, n_emb_dir=n_emb_dir,
                compute_dtype=compute_dtype, exact_encode=exact_encode,
                skips=tuple(skips))

    def run_pass(which, rays_o, rays_d, z, noise, xyz):
        params = (coarse, fine)[which]
        if isinstance(params, MlpParams) and full:
            return _split_block(*fused_render_train(
                params, rays_o, rays_d, z, noise, xyz=xyz,
                stash=stash and not pertube_cord, **opts),
                params.feat_w.shape[1])
        n, s = z.shape
        pts = _points(rays_o, rays_d, z, xyz)
        if isinstance(params, MlpParams):
            feat, sigma = fused_mlp_train(params, pts.reshape(n * s, 3),
                                          rays_d, dir_rep=s, **opts)
            feat, sigma = feat.reshape(n, s, -1), sigma.reshape(n, s)
        else:
            feat, sigma = _module_points(params, pts, rays_d, remat)
        return composite(feat, sigma, z, noise)

    return _render(run_pass, rays, n_samples,
                   n_importance if fine is not None else 0, use_disp,
                   perturb, noise_std, generator, draws, pertube_cord)
