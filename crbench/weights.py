"""Seeded weights, made on the device in a few large calls.

Every floating entry of a module's ``state_dict`` is drawn from one
uniform draw of a ``torch.Generator`` on the device, scaled per entry:
matrices and kernels He-uniform (bound sqrt(6 / fan_in), so that a deep
ReLU trunk neither fades nor blows up and the renders vary from pixel to
pixel), biases 1 / sqrt(fan_in) of their layer, PReLU slopes around
0.25, batch-norm scales around 1 with small shifts, and random running
statistics. The same flat tensor is handed to the program (copied into
its parameters) and to the reference (as named views), so both sides get
the same numbers and neither derives them from the other.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _range(name: str, shape, fan_in: Dict[str, int]) -> Tuple[float, float]:
    if name.endswith("running_mean"):
        return -0.2, 0.2
    if name.endswith("running_var"):
        return 0.5, 2.0
    if "PReLU" in name:
        return 0.1, 0.4
    if "Norm_0" in name:
        return (0.8, 1.2) if name.endswith("weight") else (-0.1, 0.1)
    if len(shape) >= 2:
        b = math.sqrt(6.0 / fan_in[name[:-len("weight")]])
        return -b, b
    b = 1.0 / math.sqrt(fan_in[name[:-len("bias")]])
    return -b, b


def seeded_entries(shapes: Dict[str, tuple], seed: int, device
                   ) -> Dict[str, torch.Tensor]:
    """``shapes`` (name -> shape, floating entries of a state_dict) ->
    name -> fp32 tensor on ``device``: views of one flat tensor drawn from
    ``seed``, in name order."""
    names = sorted(shapes)
    fan_in = {n[:-len("weight")]: math.prod(shapes[n][1:])
              for n in names if n.endswith("weight") and len(shapes[n]) >= 2}
    sizes = [math.prod(shapes[n]) for n in names]
    bounds = torch.tensor([_range(n, shapes[n], fan_in) for n in names],
                          dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    lo, hi = torch.repeat_interleave(bounds, counts, 0).unbind(1)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat = lo + (hi - lo) * flat
    return {n: v.view(shapes[n])
            for n, v in zip(names, flat.split(sizes))}


def floating_shapes(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def load_into(module: torch.nn.Module, entries: Dict[str, torch.Tensor]):
    """Copy ``entries`` into the module's parameters and buffers in place
    (one foreach copy), so an optimizer built over them keeps its
    references."""
    sd = module.state_dict(keep_vars=True)
    dst: List[torch.Tensor] = [sd[k].data for k in sorted(entries)]
    src = [entries[k].to(dst[i].dtype) for i, k in enumerate(sorted(entries))]
    torch._foreach_copy_(dst, src)


# constants of the served scene (``served_scene``)
OCTAVE_DECAY = 0.5      # weight of each octave of the position's encoding
SIGMA_QUANTILE = 0.75   # share of the viewed space left empty
SIGMA_GAIN = 4.0        # density's logit a standard deviation past it
FEATURE_STD = 1.5       # spread of each feature's logit over the space
STYLE_STD = 0.5         # spread of the rgb logit between the styles
CONTENT_STD = 0.6       # spread of the rgb logit over a frame


@torch.no_grad()
def served_scene(entries: Dict[str, torch.Tensor], fields: Dict,
                 workload: Dict, styles: List[torch.Tensor], device
                 ) -> None:
    """Turn seeded weights (``seeded_entries``) into a scene whose served
    frames depend on the pose and the style, in place.

    Random weights render a frame of one flat colour: a deep random trunk
    gives every point nearly the same features, the density spreads each
    ray's weight evenly along it, and StyleNet adds the style's mean to a
    content term a hundred times smaller. So, the same for every seed:
    the position's encoding is low-passed (octave k weighted
    ``OCTAVE_DECAY ** k``, the layer's scale kept), each NeRF's density
    and features are standardised over points of the path's rays (a
    quarter of the space dense, features spread over (0, 1)), and the
    decoder's ``unzip`` and rgb layer are scaled and its rgb bias centred
    so that the rgb logit spreads by ``STYLE_STD`` between ``styles``
    ((Ha, Wa, 3) in [-1, 1]) and by ``CONTENT_STD`` over a frame of the
    path's first pose. Every statistic is taken in float32 (no TF32) by
    the plain reference."""
    from crbench import camera
    from crbench.reference.model import enc_a, ieee_fp32, nerf_logits, \
        posenc, style_terms
    from crbench.reference.render import render

    n_xyz, n_dir = fields["N_emb_xyz"], fields["N_emb_dir"]
    depth, skip = fields["netdepth"], 4
    d = torch.ones(3 + 6 * n_xyz, device=device)
    for k in range(n_xyz):
        d[3 + 6 * k:9 + 6 * k] = OCTAVE_DECAY ** k
    d = d * (d.numel() / (d ** 2).sum()).sqrt()
    poses = camera.path_poses(workload["path_frames"])
    near, far = workload["near"], workload["far"]
    wh = (16, 12)
    K = camera.fov_k(wh, workload["fov"])
    with ieee_fp32():
        rays = torch.cat([camera.frame_rays(c2w, K, near, far, wh[::-1],
                                            device)[0]
                          for c2w in poses[::len(poses) // 8]])
        t = torch.linspace(near, far, 32, device=device)
        pts = rays[:, None, :3] + rays[:, None, 3:6] * t[:, None]
        xyz = posenc(pts.reshape(-1, 3), n_xyz)
        dirs = posenc(rays[:, 3:6], n_dir).repeat_interleave(len(t), 0)
        for p in ("nerf_coarse", "nerf_fine"):
            first, joined = (f"{p}.xyz_encoding_1.weight",
                             f"{p}.xyz_encoding_{skip + 1}.weight")
            entries[first] = entries[first] * d
            entries[joined] = torch.cat(
                [entries[joined][:, :d.numel()] * d,
                 entries[joined][:, d.numel():]], 1)
            feat, sigma = nerf_logits(entries, p, xyz, dirs, depth, (skip,))
            sigma = sigma[:, 0]
            g = SIGMA_GAIN / sigma.std()
            entries[f"{p}.sigma.weight"] = entries[f"{p}.sigma.weight"] * g
            entries[f"{p}.sigma.bias"] = (
                entries[f"{p}.sigma.bias"]
                - torch.quantile(sigma, SIGMA_QUANTILE)) * g
            g = FEATURE_STD / feat.std(0)
            entries[f"{p}.feature.weight"] = (
                entries[f"{p}.feature.weight"] * g[:, None])
            entries[f"{p}.feature.bias"] = (
                entries[f"{p}.feature.bias"] - feat.mean(0)) * g

        # the decoder, over a small frame of the first pose and every style
        rays = camera.frame_rays(poses[0], K, near, far, wh[::-1], device)[0]
        fmap = render(entries, rays, fields)[1].reshape(1, *wh[::-1], -1)
        s01 = (torch.stack(styles) + 1.0) / 2.0
        emb = enc_a(entries, "enc_a", s01)
        fused, s_mean = style_terms(entries, fmap.expand(len(styles),
                                                         -1, -1, -1), emb)
        un, rgb = "decoder.multi_net.unzip", "decoder.decoder.feat_2_rgb_0"
        w_rgb = entries[rgb + ".weight"][:, :, 0, 0]
        content = fused.flatten(1, 2) @ entries[un + ".weight"][:, :, 0, 0].T
        rest = entries[un + ".bias"] + s_mean.flatten(1, 2)
        a = STYLE_STD / (rest @ w_rgb.T)[:, 0].std(0).mean()
        u = CONTENT_STD / (a * (content @ w_rgb.T).std(1).mean())
        logit = (u * content + rest) @ (a * w_rgb).T
        entries[un + ".weight"] = entries[un + ".weight"] * u
        entries[rgb + ".weight"] = entries[rgb + ".weight"] * a
        entries[rgb + ".bias"] = -logit.mean((0, 1))
