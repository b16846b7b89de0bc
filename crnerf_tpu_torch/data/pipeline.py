"""Host-side batch pipeline: Scene + GridSampler -> fixed-shape batches
(``crnerf_tpu/data/pipeline.py`` ``TrainPipeline``: ``make_batch`` and
``make_global_batch``; numpy).

Every batch is a pure function of (epoch, idx), all arrays have fixed
shapes, and a "global batch" stacks n independent grids on a leading axis.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from crnerf_tpu_torch.data.sampler import GridSampler
from crnerf_tpu_torch.data.scene import Scene


class TrainPipeline:
    def __init__(
        self,
        scene: Scene,
        batch_size: int = 1024,
        scale_anneal: float = -1.0,
        min_scale: float = 0.5,
        seed_salt: int = 0,
    ):
        if scene.all_rays is None:
            scene.build_ray_buffers()
        self.scene = scene
        train = scene.train_images
        self.image_whs = np.asarray([im.wh for im in train], np.int64)
        self.image_ids = np.asarray([im.id for im in train], np.int64)
        self.sampler = GridSampler(
            n_images=len(train),
            image_whs=self.image_whs,
            offsets=scene.offsets,
            batch_size=batch_size,
            scale_anneal=scale_anneal,
            min_scale=min_scale,
            seed_salt=seed_salt,
        )
        self.batch_size = batch_size

    @property
    def iterations(self) -> int:
        return self.sampler.iterations

    def make_batch(self, epoch: int, idx: int) -> Dict[str, np.ndarray]:
        """One image-grid batch. Keys: rays (B, 8), ts (B,), rgbs (B, 3),
        whole_img (1, Ha, Wa, 3) in [-1, 1], uv_pix (B, 2), image_idx ()."""
        s = self.sampler.sample(epoch, idx)
        ray_rows = self.scene.all_rays[s["ray_idx"]]
        return {
            "rays": ray_rows[:, :8].astype(np.float32),
            "ts": ray_rows[:, 8].astype(np.int32),
            "rgbs": self.scene.all_rgbs[s["ray_idx"]].astype(np.float32),
            "whole_img": self.scene.appearance_stack[s["image_idx"]][None],
            "uv_pix": s["uv_pix"],
            "image_idx": np.int32(s["image_idx"]),
        }

    def make_global_batch(
        self, epoch: int, idx: int, n_grids: int
    ) -> Dict[str, np.ndarray]:
        """Stack n_grids independent grids on a leading axis. Grid d of
        step idx consumes draw ``idx * n_grids + d``, so the stream equals
        the single-grid stream split round-robin."""
        parts = [
            self.make_batch(epoch, idx * n_grids + d)
            for d in range(n_grids)
        ]
        return {
            k: np.stack([p[k] for p in parts], 0) for k in parts[0]
        }
