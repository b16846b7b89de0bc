"""Camera helpers of the serving path, copied from
``crnerf_tpu/render/camera_path.py`` (which cannot be imported without jax:
``crnerf_tpu/render/__init__.py`` imports the JAX renderer)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def fov_intrinsics(img_wh: Tuple[int, int],
                   fov_deg: float = 60.0) -> np.ndarray:
    """Pinhole K with horizontal fov (reference test_K, eval.py:135-139)."""
    w, h = img_wh
    focal = w / 2 / math.tan(math.radians(fov_deg) / 2)
    return np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
    )
