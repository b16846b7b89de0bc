"""Host-side batch pipeline: Scene + GridSampler -> fixed-shape batches
(``crnerf_tpu/data/pipeline.py``: ``TrainPipeline`` with ``make_batch``,
``make_global_batch`` and ``epoch_batches``, and ``full_image_batch``;
numpy).

Every batch is a pure function of (epoch, idx), all arrays have fixed
shapes, and a "global batch" stacks n independent grids on a leading axis.
With D ranks of G grids, rank r of step i takes grids ``i D G + r G`` to
``i D G + r G + G - 1`` of the stream: the JAX package's global batch of D G
grids reshaped to (D, G, ...), each rank building only its own row.
``epoch_batches`` assembles an epoch's batches on a thread, a few ahead of
the consumer; ``start_step`` starts it mid-epoch, which is what makes a
resume after a stop replay the exact remaining sequence.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

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
        self, epoch: int, idx: int, n_grids: int, rank: int = 0,
        world: int = 1,
    ) -> Dict[str, np.ndarray]:
        """Stack n_grids independent grids on a leading axis. Grid g of
        rank r at step idx consumes draw ``(idx * world + r) * n_grids +
        g``, so the stream equals the single-grid stream split
        round-robin."""
        first = (idx * world + rank) * n_grids
        parts = [self.make_batch(epoch, first + g) for g in range(n_grids)]
        return {
            k: np.stack([p[k] for p in parts], 0) for k in parts[0]
        }

    def epoch_batches(self, epoch: int, n_grids: int = 1,
                      n_steps: Optional[int] = None, start_step: int = 0,
                      prefetch: int = 2, rank: int = 0, world: int = 1
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Steps ``start_step`` to ``n_steps`` of ``epoch``, each rank
        ``rank``'s batch of ``n_grids`` grids of a step of ``world`` ranks
        ((G, B, ...) arrays; flat (B, ...) when G is 1), made on a thread
        up to ``prefetch`` ahead. A consumer that stops early leaves no
        thread behind: the queue is drained so that the producer sees the
        stop."""
        g = max(1, n_grids)
        if n_steps is None:
            n_steps = max(1, self.iterations // (g * world))
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            for i in range(start_step, n_steps):
                if stop.is_set():
                    return
                q.put(self.make_global_batch(epoch, i, g, rank, world)
                      if g > 1 else self.make_batch(epoch, i * world + rank))
            q.put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                yield b
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def full_image_batch(scene: Scene, image, appearance_img=None
                     ) -> Dict[str, np.ndarray]:
    """Whole-image batch of one SceneImage: rays for every pixel and the
    image's own appearance input (or ``appearance_img`` in its place)."""
    rays = scene.image_rays(image)
    app = appearance_img if appearance_img is not None else image.appearance
    return {
        "rays": rays.astype(np.float32),
        "ts": np.full((rays.shape[0],), image.id, np.int32),
        "rgbs": (image.rgbs.astype(np.float32) if image.rgbs is not None
                 else np.zeros((rays.shape[0], 3), np.float32)),
        "whole_img": app[None].astype(np.float32),
        "img_wh": np.asarray(image.wh, np.int64),
    }
