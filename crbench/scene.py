"""The training cell's scene, made from the seed: a frozen copy of the
synthetic scene of ``crnerf_tpu_torch/data/synthetic.py`` (a lambertian
sphere over a textured ground plane under a sky gradient, cameras on a
circle, a colour tint per image) and of the pinhole ray arithmetic of
``core/rays.py``, in numpy. The seed draws each image's tint; the
cameras, sizes and every shape are the same for every seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Image:
    id: int
    K: np.ndarray          # (3, 3) float32
    c2w: np.ndarray        # (3, 4) float32
    wh: Tuple[int, int]
    rgbs: np.ndarray       # (h*w, 3) float32 in [0, 1], row-major
    appearance: np.ndarray  # (Ha, Wa, 3) float32 in [-1, 1]
    near: float
    far: float


def ray_directions(h: int, w: int, K: np.ndarray) -> np.ndarray:
    """(h, w, 3) camera-frame directions at pixel corners:
    ((i - cx) / fx, -(j - cy) / fy, -1)."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    return np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                     -np.ones_like(i)], axis=-1)


def world_rays(dirs: np.ndarray, c2w: np.ndarray):
    """-> origins, unit directions, each (n, 3)."""
    d = dirs.reshape(-1, 3) @ c2w[:, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(c2w[:, 3], d.shape), d


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.concatenate([np.stack([right, up, -fwd], 1), eye[:, None]],
                          1).astype(np.float32)


def _shade(o, d, tint, light):
    t_up = 0.5 * (d[:, 1] + 1.0)
    rgb = ((1 - t_up[:, None]) * np.array([0.9, 0.9, 1.0])
           + t_up[:, None] * np.array([0.3, 0.5, 0.9]))
    denom = d[:, 1]
    tp = (-1.0 - o[:, 1]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    hit_p = (tp > 1e-3) & (denom < 0)
    px, pz = o[:, 0] + tp * d[:, 0], o[:, 2] + tp * d[:, 2]
    ground = 0.45 + 0.25 * np.sin(0.9 * px) * np.cos(0.9 * pz)
    fade = np.exp(-0.02 * (px ** 2 + pz ** 2))
    ground = 0.4 * (1 - fade) + ground * fade
    rgb[hit_p] = ground[hit_p, None]
    b = np.einsum("nd,nd->n", o, d)
    disc = b * b - (np.einsum("nd,nd->n", o, o) - 1.0)
    ts = -b - np.sqrt(np.maximum(disc, 0.0))
    hit_s = (disc > 0) & (ts > 1e-3) & (~hit_p | (ts < tp))
    nrm = o + ts[:, None] * d
    lam = np.clip(nrm @ light, 0.0, 1.0)
    col = 0.15 + 0.85 * lam[:, None] * np.array([0.9, 0.35, 0.25])
    rgb[hit_s] = col[hit_s]
    return np.clip(rgb * tint[None], 0.0, 1.0).astype(np.float32)


def _resize_nearest(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    yi = np.clip((np.arange(wh[1]) + 0.5) * h / wh[1], 0, h - 1).astype(int)
    xi = np.clip((np.arange(wh[0]) + 0.5) * w / wh[0], 0, w - 1).astype(int)
    return img[yi][:, xi]


def make_images(n: int, img_wh: Tuple[int, int],
                appearance_wh: Tuple[int, int], seed: int,
                near: float = 0.5, far: float = 6.0) -> List[Image]:
    """``n`` training images of ``img_wh`` on a circle of cameras."""
    rng = np.random.default_rng(seed)
    w, h = img_wh
    focal = 0.9 * w
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    light = np.array([0.4, 0.8, 0.45])
    light = light / np.linalg.norm(light)
    dirs = ray_directions(h, w, K)
    images = []
    for i in range(n):
        th = 2 * np.pi * i / n
        eye = np.array([3.0 * np.sin(th), 0.8 + 0.2 * np.sin(3 * th),
                        3.0 * np.cos(th)])
        c2w = _look_at(eye, np.zeros(3))
        o, d = world_rays(dirs, c2w)
        tint = 1.0 + 0.25 * rng.uniform(-1, 1, 3)
        rgbs = _shade(o.astype(np.float64), d.astype(np.float64), tint,
                      light)
        app = _resize_nearest(rgbs.reshape(h, w, 3), appearance_wh)
        images.append(Image(id=i, K=K.copy(), c2w=c2w, wh=(w, h), rgbs=rgbs,
                            appearance=(app * 2.0 - 1.0).astype(np.float32),
                            near=near, far=far))
    return images


def grid_rays(im: Image, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The (n, 8) rays [o | d | near | far] of pixels (rows, cols) of an
    image, from its camera."""
    K = im.K
    dirs = np.stack([(cols.astype(np.float32) - K[0][2]) / K[0][0],
                     -(rows.astype(np.float32) - K[1][2]) / K[1][1],
                     -np.ones(rows.shape, np.float32)], -1)
    o, d = world_rays(dirs, im.c2w)
    n = len(rows)
    return np.concatenate([o, d, np.full((n, 1), im.near, np.float32),
                           np.full((n, 1), im.far, np.float32)],
                          1).astype(np.float32)
