"""The grid sampler: CR-NeRF's cross-ray batching strategy as a pure,
seeded function (``crnerf_tpu/data/sampler.py``, numpy).

Each train step samples a sqrt(B) x sqrt(B) *pixel grid* from one image —
linspace grids over normalized coords, a random zoom ``scale`` in
[min_scale_cur, 1], a random offset keeping the grid inside the image, floor
to pixel indices, and a flat offset into the global ray buffer. The decoded
batch is a coherent s x s image patch (H = W = sqrt(B)) — that coherence is what lets the style head treat the
batch as a feature *map*.

Determinism: all draws of a step come from one
RandomState(epoch*iters+idx), so every batch is a pure function of
(epoch, idx).

``scale_anneal > 0`` shrinks min_scale_cur exponentially.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def min_scale_cur(step: int, scale_anneal: float, min_scale: float) -> float:
    if scale_anneal > 0:
        return min(max(min_scale, math.exp(-step * scale_anneal)), 0.9)
    return min_scale


def grid_sample_indices(
    rng: np.random.RandomState,
    img_wh: Tuple[int, int],
    batch_size: int,
    min_scale_now: float,
    round_mode: str = "floor",
):
    """One grid draw for an image of size (w, h).

    Returns (flat_pixel_idx (B,), uv_sample (B,2)=(v,u) normalized,
    uv_pix (B,2) pixel-center coords for mask gathering).
    Ordering is h-major (row-major).
    """
    w, h = int(img_wh[0]), int(img_wh[1])
    s = int(round(math.sqrt(batch_size)))
    assert s * s == batch_size, "batch_size must be a perfect square"

    w_lin = np.linspace(0, 1 - 1 / w, s, dtype=np.float64)
    h_lin = np.linspace(0, 1 - 1 / h, s, dtype=np.float64)

    scale = rng.uniform(min_scale_now, 1.0)
    h_off = rng.uniform(0, (1 - scale) * (1 - 1 / h))
    w_off = rng.uniform(0, (1 - scale) * (1 - 1 / w))

    h_sb = h_lin * scale + h_off   # (s,)
    w_sb = w_lin * scale + w_off   # (s,)

    rnd = np.floor if round_mode == "floor" else np.round
    hi = rnd(h_sb * h).astype(np.int64)        # rows
    wi = rnd(w_sb * w).astype(np.int64)        # cols
    hi = np.clip(hi, 0, h - 1)
    wi = np.clip(wi, 0, w - 1)

    # h-major grid: rows vary slowest
    flat = (hi[:, None] * w + wi[None, :]).reshape(-1)
    vv, uu = np.meshgrid(h_sb, w_sb, indexing="ij")
    uv_sample = np.stack([vv.reshape(-1), uu.reshape(-1)], -1)
    ch = (hi.astype(np.float64) + 0.5) / h
    cw = (wi.astype(np.float64) + 0.5) / w
    cvv, cuu = np.meshgrid(ch, cw, indexing="ij")
    uv_pix = np.stack([cvv.reshape(-1), cuu.reshape(-1)], -1)
    return flat, uv_sample.astype(np.float32), uv_pix.astype(np.float32)


@dataclasses.dataclass
class GridSampler:
    """Epoch-seeded sampler over a Scene's flat ray buffer."""

    n_images: int
    image_whs: np.ndarray          # (n_images, 2) of (w, h)
    offsets: np.ndarray            # (n_images+1,)
    batch_size: int = 1024
    scale_anneal: float = -1.0
    min_scale: float = 0.5
    seed_salt: int = 0

    @property
    def iterations(self) -> int:
        """Steps per epoch = total rays // batch."""
        return int(self.offsets[-1]) // self.batch_size

    def sample(self, epoch: int, idx: int):
        """-> dict(image_idx, ray_idx (B,), uv_sample, uv_pix,
        min_scale_cur)."""
        step = epoch * self.iterations + idx
        rng = np.random.RandomState(
            (step + self.seed_salt) % (2 ** 31)
        )
        image_idx = int(rng.randint(0, self.n_images))
        msc = min_scale_cur(step, self.scale_anneal, self.min_scale)
        flat, uv_sample, uv_pix = grid_sample_indices(
            rng, self.image_whs[image_idx], self.batch_size, msc
        )
        return {
            "image_idx": image_idx,
            "ray_idx": flat + self.offsets[image_idx],
            "pixel_idx": flat,
            "uv_sample": uv_sample,
            "uv_pix": uv_pix,
            "min_scale_cur": msc,
        }
