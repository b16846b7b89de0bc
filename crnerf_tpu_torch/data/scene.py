"""Scene container: the processed, framework-facing form of a dataset
(``crnerf_tpu/data/scene.py``, numpy).

Every training image contributes its full ray set to one flat (N, 9) buffer
[o, d, near, far, ts] plus (N, 3) rgbs, with per-image offsets for the grid
sampler. Appearance inputs are resized to ONE static (Ha, Wa) so the whole
train step sees one shape.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from crnerf_tpu_torch.core.rays import (
    get_ray_directions_np as get_ray_directions,
    make_ray_buffer,
)


@dataclasses.dataclass
class SceneImage:
    id: int                      # ts / vocab index
    name: str
    K: np.ndarray                # (3,3) at working downscale
    c2w: np.ndarray              # (3,4)
    near: float
    far: float
    wh: Tuple[int, int]          # (w, h) at working downscale
    rgbs: Optional[np.ndarray] = None          # (h*w, 3) float32 [0,1]
    appearance: Optional[np.ndarray] = None    # (Ha, Wa, 3) in [-1,1]
    split: str = "train"


@dataclasses.dataclass
class Scene:
    name: str
    images: List[SceneImage]
    white_back: bool = False
    appearance_wh: Tuple[int, int] = (224, 160)  # (W, H)

    # built by build_ray_buffers()
    all_rays: Optional[np.ndarray] = None      # (N, 9)
    all_rgbs: Optional[np.ndarray] = None      # (N, 3)
    offsets: Optional[np.ndarray] = None       # (n_train+1,) ray offsets
    appearance_stack: Optional[np.ndarray] = None  # (n_train, Ha, Wa, 3)

    @property
    def train_images(self) -> List[SceneImage]:
        return [im for im in self.images if im.split == "train"]

    @property
    def test_images(self) -> List[SceneImage]:
        return [im for im in self.images if im.split == "test"]

    def build_ray_buffers(self):
        """Materialize the flat ray/rgb buffers for the train split."""
        rays, rgbs, offs, apps = [], [], [0], []
        for im in self.train_images:
            w, h = im.wh
            dirs = get_ray_directions(h, w, im.K)
            rays.append(
                make_ray_buffer(dirs, im.c2w, im.near, im.far, im.id)
            )
            rgbs.append(im.rgbs.astype(np.float32))
            offs.append(offs[-1] + h * w)
            apps.append(im.appearance)
        self.all_rays = np.concatenate(rays, 0)
        self.all_rgbs = np.concatenate(rgbs, 0)
        self.offsets = np.asarray(offs, np.int64)
        self.appearance_stack = np.stack(apps, 0).astype(np.float32)
        return self

    def image_rays(self, im: SceneImage) -> np.ndarray:
        """Full-image (h*w, 8) rays for val/eval renders."""
        w, h = im.wh
        dirs = get_ray_directions(h, w, im.K)
        return make_ray_buffer(dirs, im.c2w, im.near, im.far, im.id)[:, :8]

    def n_rays(self) -> int:
        return 0 if self.all_rays is None else len(self.all_rays)
