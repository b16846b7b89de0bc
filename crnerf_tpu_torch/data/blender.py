"""Blender synthetic dataset (NeRF-W-style perturbed benchmark) -> ``Scene``
(``crnerf_tpu/data/blender.py``), decoded and resized without an image
library (``utils/png.py``, ``utils/lanczos.py``).

- ``transforms_{split}.json``: per-frame c2w 4x4, shared intrinsics from
  ``camera_angle_x`` at the nominal 800 px width, rescaled to ``img_wh``.
- near/far = 2/6, white background (alpha-blended to white).
- Train-time perturbations of every frame but frame 0, at full resolution
  before the white blend: ``occ`` draws ten random-colour bars (a
  synthetic transient occluder), ``color`` a per-channel affine jitter (a
  synthetic appearance change). Both are seeded by the frame index through
  ``np.random.RandomState``, so they are the JAX loader's bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from crnerf_tpu_torch.data.scene import Scene, SceneImage
from crnerf_tpu_torch.utils.lanczos import resize_lanczos
from crnerf_tpu_torch.utils.png import read_png

NEAR, FAR = 2.0, 6.0


def add_perturbation(img: np.ndarray, perturbation: Sequence[str],
                     seed: int) -> np.ndarray:
    """img: (H, W, 3) float [0,1] at full (pre-resize) resolution. 'occ'
    draws ten 200px-tall, 20px-wide random-colour bars starting at a seeded
    (left, top) in [200, 400); 'color' applies a seeded per-channel affine
    jitter s in [0.8, 1.2], b in [-0.2, 0.2]."""
    img = img.copy()
    h, w = img.shape[:2]
    if "occ" in perturbation:
        rng = np.random.RandomState(seed)
        left = rng.randint(200, 400)
        top = rng.randint(200, 400)
        for i in range(10):
            rng_i = np.random.RandomState(10 * seed + i)
            color = rng_i.choice(range(256), 3).astype(np.float32) / 255.0
            x0, x1 = left + 20 * i, left + 20 * (i + 1)
            y0, y1 = top, top + 200
            img[max(0, y0):min(h, y1 + 1), max(0, x0):min(w, x1 + 1)] = color
    if "color" in perturbation:
        rng = np.random.RandomState(seed)
        s = rng.uniform(0.8, 1.2, size=3)
        b = rng.uniform(-0.2, 0.2, size=3)
        img = np.clip(s * img + b, 0.0, 1.0)
    return img.astype(np.float32)


def _resize_area(img: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    """float [0, 1] -> truncated to uint8 (not rounded, as the JAX loader
    does) -> Lanczos to ``out_wh`` -> float [0, 1]."""
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return resize_lanczos(u8, out_wh).astype(np.float32) / 255.0


def load_blender(
    root_dir: str,
    split: str = "train",
    img_wh: Tuple[int, int] = (800, 800),
    perturbation: Sequence[str] = (),
    appearance_wh: Tuple[int, int] = (224, 160),
) -> Scene:
    if not set(perturbation) <= {"color", "occ"}:
        raise ValueError(f"perturbation must be a subset of color, occ; got "
                         f"{tuple(perturbation)}")
    json_split = split.split("_")[-1]
    with open(os.path.join(root_dir, f"transforms_{json_split}.json")) as f:
        meta = json.load(f)
    w, h = img_wh
    focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) * (w / 800)
    K = np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
    )

    images = []
    for t, frame in enumerate(meta["frames"]):
        c2w = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        path = os.path.join(root_dir, f"{frame['file_path']}.png")
        rgba = read_png(path, "RGBA").astype(np.float32) / 255.0
        rgb, alpha = rgba[..., :3], rgba[..., 3:]
        if t != 0 and split == "train" and perturbation:
            rgb = add_perturbation(rgb, perturbation, t)
        rgb = rgb * alpha + (1.0 - alpha)
        rgb_rs = _resize_area(rgb, img_wh)
        app = _resize_area(rgb, appearance_wh) * 2.0 - 1.0
        images.append(
            SceneImage(
                id=t,
                name=frame["file_path"],
                K=K.copy(),
                c2w=c2w,
                near=NEAR,
                far=FAR,
                wh=img_wh,
                rgbs=rgb_rs.reshape(-1, 3),
                appearance=app.astype(np.float32),
                split="train" if split == "train" else "test",
            )
        )
    return Scene(
        name=os.path.basename(os.path.normpath(root_dir)),
        images=images,
        white_back=True,
        appearance_wh=appearance_wh,
    )
