"""Camera-ray generation (``crnerf_tpu/core/rays.py``).

Pixel-corner sampling with no +0.5 centering, the right-up-back camera frame
d = ((i-cx)/fx, -(j-cy)/fy, -1), world directions normalized to unit length.
``cam_rays_uv`` is the on-device ray maker of the serving path
(``crnerf_tpu/render/inference.py`` ``_cam_rays_uv``). The ``*_np``
functions are the host-side numpy forms the data layer builds its ray
buffers with. ``get_ndc_rays`` is the reference's NDC transform, on no
path of the system (as in the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_ray_directions(h: int, w: int, K, device=None) -> torch.Tensor:
    """(h, w, 3) camera-frame directions for intrinsics K (3, 3)."""
    fx, fy, cx, cy = (float(K[0][0]), float(K[1][1]), float(K[0][2]),
                      float(K[1][2]))
    j, i = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """directions (h, w, 3), c2w (3, 4) -> rays_o, rays_d each (h*w, 3),
    rays_d unit length."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def _ndc_rays(H, W, focal, near, rays_o, rays_d, stack):
    """The NDC transform in the JAX package's order of operations, for
    torch tensors or numpy arrays (``stack`` the library's stack)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return stack([o0, o1, o2], -1), stack([d0, d1, d2], -1)


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o: torch.Tensor,
                 rays_d: torch.Tensor):
    """World rays (..., 3) -> their origins and directions in normalized
    device coordinates: each ray moved to the near plane z = -near, then
    x, y scaled by 2 focal / (W, H) over -z and z mapped to 1 + 2 near / z
    (``crnerf_tpu/core/rays.py`` ``get_ndc_rays``)."""
    return _ndc_rays(H, W, focal, near, rays_o, rays_d, torch.stack)


def cam_rays_uv(c2w: torch.Tensor, intr: torch.Tensor, near: float,
                far: float, hw: Tuple[int, int]):
    """All rays (h*w, 8) = [o | d | near | far] and pixel-centre uv (h*w, 2)
    of an (h, w) frame, made on the device of ``c2w``.

    The rotation is written out elementwise, as in the JAX package: nine
    f32 multiply-adds per ray, not a matrix product whose precision the
    backend picks (the TPU's default matmul precision moved samples
    visibly)."""
    h, w = hw
    dev = c2w.device
    idx = torch.arange(h * w, device=dev)
    jj = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    ii = (idx % w).to(torch.float32)
    d_cam = torch.stack(
        [(ii - intr[2]) / intr[0], -(jj - intr[3]) / intr[1],
         -torch.ones_like(ii)], -1,
    )
    R = c2w[:, :3]
    rays_d = (d_cam[:, 0:1] * R[None, :, 0]
              + d_cam[:, 1:2] * R[None, :, 1]
              + d_cam[:, 2:3] * R[None, :, 2])
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    n = idx.shape[0]
    rays = torch.cat(
        [c2w[:, 3].expand(n, 3), rays_d,
         torch.full((n, 1), float(near), device=dev),
         torch.full((n, 1), float(far), device=dev)], 1,
    )
    uv = torch.stack([(jj + 0.5) / h, (ii + 0.5) / w], -1)
    return rays, uv


def get_ray_directions_np(h: int, w: int, K) -> np.ndarray:
    """``get_ray_directions`` in numpy (float32)."""
    fx, fy, cx, cy = K[0][0], K[1][1], K[0][2], K[1][2]
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)],
                    axis=-1)


def get_rays_np(directions: np.ndarray, c2w: np.ndarray):
    """``get_rays`` in numpy."""
    rays_d = directions @ np.swapaxes(c2w[:, :3], -1, -2)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def get_ndc_rays_np(H: int, W: int, focal: float, near,
                    rays_o: np.ndarray, rays_d: np.ndarray):
    """``get_ndc_rays`` in numpy."""
    return _ndc_rays(H, W, focal, near, rays_o, rays_d, np.stack)


def make_ray_buffer(directions: np.ndarray, c2w: np.ndarray, near: float,
                    far: float, ts: int) -> np.ndarray:
    """One image's rays in the flat 9-float layout
    [o(3), d(3), near, far, ts]."""
    rays_o, rays_d = get_rays_np(directions, c2w)
    ones = np.ones((rays_o.shape[0], 1), dtype=np.float32)
    return np.concatenate(
        [rays_o, rays_d, near * ones, far * ones, float(ts) * ones], axis=1
    ).astype(np.float32)
