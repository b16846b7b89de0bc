"""Procedural synthetic scenes: the self-contained test and smoke-run data
source (``crnerf_tpu/data/synthetic.py``, numpy).

A tiny analytic scene (lambertian sphere
+ ground plane, cameras on a circle) whose images are computed by closed-form
ray casting. This gives:

- a learnable target for train-to-PSNR integration tests,
- per-image appearance variation (color tints) exercising the appearance
  encoder/cache path exactly like Phototourism's lighting changes,
- optional per-image synthetic occluders exercising the transient-mask path.

Everything is numpy; the output is a standard ``Scene``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from crnerf_tpu_torch.core.rays import (
    get_ray_directions_np as get_ray_directions,
    get_rays_np as get_rays,
)
from crnerf_tpu_torch.data.scene import Scene, SceneImage


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)):
    """c2w (3,4) in the right-up-back convention the ray generator expects
    (camera looks along -z)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    # columns: x=right, y=up, z=back(-forward)
    R = np.stack([right, true_up, -fwd], axis=1)
    return np.concatenate([R, eye[:, None]], axis=1).astype(np.float32)


def _shade(rays_o, rays_d, tint, sphere_c, sphere_r, light_dir):
    """Closed-form render: lambertian sphere over a checkered ground plane,
    sky gradient background. Returns (N, 3) in [0, 1]."""
    n = rays_o.shape[0]
    rgb = np.zeros((n, 3), np.float64)

    # sky: gradient on ray elevation
    t_up = 0.5 * (rays_d[:, 1] + 1.0)
    sky = (1 - t_up[:, None]) * np.array([0.9, 0.9, 1.0]) + t_up[:, None] * (
        np.array([0.3, 0.5, 0.9])
    )
    rgb[:] = sky

    # ground plane y = -sphere_r. A smooth low-frequency texture — a hard
    # checkerboard would alias under point sampling and cap achievable
    # PSNR around a 3x3 blur (~17 dB), hiding real convergence signal in
    # train-to-PSNR tests.
    denom = rays_d[:, 1]
    tp = (-sphere_r - rays_o[:, 1]) / np.where(
        np.abs(denom) < 1e-9, 1e-9, denom
    )
    hit_p = (tp > 1e-3) & (denom < 0)
    px = rays_o[:, 0] + tp * rays_d[:, 0]
    pz = rays_o[:, 2] + tp * rays_d[:, 2]
    ground = 0.45 + 0.25 * np.sin(0.9 * px) * np.cos(0.9 * pz)
    fade = np.exp(-0.02 * (px ** 2 + pz ** 2))  # fade far plane to grey
    ground = 0.4 * (1 - fade) + ground * fade
    for c in range(3):
        rgb[hit_p, c] = ground[hit_p]

    # sphere at sphere_c radius sphere_r
    oc = rays_o - sphere_c
    b = np.einsum("nd,nd->n", oc, rays_d)
    cc = np.einsum("nd,nd->n", oc, oc) - sphere_r ** 2
    disc = b * b - cc
    hit_s = disc > 0
    ts = -b - np.sqrt(np.maximum(disc, 0.0))
    hit_s &= ts > 1e-3
    # sphere occludes ground only where closer
    hit_s_final = hit_s & (~hit_p | (ts < tp))
    p = rays_o + ts[:, None] * rays_d
    nrm = (p - sphere_c) / sphere_r
    lam = np.clip(np.einsum("nd,d->n", nrm, light_dir), 0.0, 1.0)
    base = np.array([0.9, 0.35, 0.25])
    col = 0.15 + 0.85 * lam[:, None] * base[None, :]
    rgb[hit_s_final] = col[hit_s_final]

    return np.clip(rgb * tint[None, :], 0.0, 1.0).astype(np.float32)


def _resize_nearest(img: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    """Cheap nearest resize for building the fixed-shape appearance input."""
    h, w = img.shape[:2]
    ow, oh = out_wh
    yi = np.clip((np.arange(oh) + 0.5) * h / oh, 0, h - 1).astype(np.int64)
    xi = np.clip((np.arange(ow) + 0.5) * w / ow, 0, w - 1).astype(np.int64)
    return img[yi][:, xi]


def make_synthetic_scene(
    n_train: int = 6,
    n_test: int = 2,
    img_wh: Tuple[int, int] = (48, 36),
    appearance_wh: Tuple[int, int] = (64, 48),
    tint_strength: float = 0.25,
    occluders: bool = False,
    seed: int = 0,
    near: float = 0.5,
    far: float = 6.0,
) -> Scene:
    """Build a fully-populated Scene (ray buffers NOT yet built — call
    ``.build_ray_buffers()``)."""
    rng = np.random.RandomState(seed)
    w, h = img_wh
    focal = 0.9 * w
    K = np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
    )
    sphere_c = np.array([0.0, 0.0, 0.0])
    sphere_r = 1.0
    light = np.array([0.4, 0.8, 0.45])
    light = light / np.linalg.norm(light)

    images = []
    n_total = n_train + n_test
    for i in range(n_total):
        theta = 2 * np.pi * i / n_total
        eye = np.array(
            [3.0 * np.sin(theta), 0.8 + 0.2 * np.sin(3 * theta),
             3.0 * np.cos(theta)]
        )
        c2w = _look_at(eye, sphere_c)
        dirs = get_ray_directions(h, w, K)
        rays_o, rays_d = get_rays(dirs, c2w)

        tint = 1.0 + tint_strength * (rng.uniform(-1, 1, 3))
        rgbs = _shade(rays_o, rays_d, tint, sphere_c, sphere_r, light)

        img = rgbs.reshape(h, w, 3)
        if occluders and i % 2 == 0:
            # paint a transient box (never multi-view consistent)
            bh, bw = h // 4, w // 4
            y0 = rng.randint(0, h - bh)
            x0 = rng.randint(0, w - bw)
            img = img.copy()
            img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(0, 1, 3)
            rgbs = img.reshape(-1, 3)

        app = _resize_nearest(img, appearance_wh) * 2.0 - 1.0  # [-1,1]
        images.append(
            SceneImage(
                id=i,
                name=f"synth_{i:03d}.png",
                K=K.copy(),
                c2w=c2w,
                near=near,
                far=far,
                wh=(w, h),
                rgbs=rgbs,
                appearance=app.astype(np.float32),
                split="train" if i < n_train else "test",
            )
        )
    return Scene(
        name="synthetic",
        images=images,
        white_back=False,
        appearance_wh=appearance_wh,
    )
