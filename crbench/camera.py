"""The serving cells' cameras: a frozen copy of the pose arithmetic of
``crnerf_tpu_torch/render/camera_path.py`` (the reference's
brandenburg_gate demo path of 240 poses around its anchor pose, a fov-60
pinhole) and of ``core/rays.py`` ``cam_rays_uv`` (all rays of a frame and
their pixel-centre uv), in numpy and plain torch.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# the reference's appearance_modification_video.py:47-50 for
# brandenburg_gate, 240 frames; the anchor is the stand-alone demo's pose
PATH = dict(
    dx=[(-0.25, 0.25, 1.0)],
    dy=[(0.05, -0.1, 0.5), (-0.1, 0.05, 0.5)],
    dz=[(0.1, 0.3, 0.5), (0.3, 0.1, 0.5)],
    theta_x=[(math.pi / 30, 0.0, 0.5), (0.0, math.pi / 30, 0.5)],
    theta_y=[(math.pi / 10, -math.pi / 10, 1.0)],
    theta_z=[],
)
ANCHOR = np.array([[0.997, 0.0017, -0.077, 0.0355],
                   [0.0108, -0.9929, 0.1181, 0.0234],
                   [-0.0763, -0.1186, -0.9900, 0.1216]], np.float32)


def _euler(t: Sequence[float]) -> np.ndarray:
    cx, sx = math.cos(t[0]), math.sin(t[0])
    cy, sy = math.cos(t[1]), math.sin(t[1])
    cz, sz = math.cos(t[2]), math.sin(t[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def _segments(segs, n: int) -> np.ndarray:
    if not segs:
        return np.zeros(n)
    counts = [int(n * f) for (_, _, f) in segs[:-1]]
    counts.append(n - sum(counts))
    return np.concatenate([np.linspace(s, e, c)
                           for (s, e, _), c in zip(segs, counts)])


def path_poses(n: int = 240) -> np.ndarray:
    """(n, 3, 4) float32 poses of the demo path, made in float64."""
    p = {k: _segments(v, n) for k, v in PATH.items()}
    out = np.tile(ANCHOR.astype(np.float64), (n, 1, 1))
    out[:, 0, 3] += p["dx"]
    out[:, 1, 3] += p["dy"]
    out[:, 2, 3] += p["dz"]
    for i in range(n):
        out[i, :, :3] = _euler((p["theta_x"][i], p["theta_y"][i],
                                p["theta_z"][i])) @ out[i, :, :3]
    return out.astype(np.float32)


def fov_k(wh: Tuple[int, int], fov_deg: float = 60.0) -> np.ndarray:
    w, h = wh
    f = w / 2 / math.tan(math.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def frame_rays(c2w, K, near: float, far: float, hw: Tuple[int, int],
               device):
    """All rays (h*w, 8) = [o | d | near | far] of a frame, row-major
    from pixel corners, and the pixel-centre (v, u) (h*w, 2), in float32
    torch on ``device``."""
    import torch

    h, w = hw
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                       device=device),
                          torch.arange(w, dtype=torch.float32,
                                       device=device), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    d = torch.stack([(i - float(K[0][2])) / float(K[0][0]),
                     -(j - float(K[1][2])) / float(K[1][1]),
                     -torch.ones_like(i)], -1)
    d = d @ c2w[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    n = h * w
    rays = torch.cat([c2w[:, 3].expand(n, 3), d,
                      torch.full((n, 1), near, device=device),
                      torch.full((n, 1), far, device=device)], 1)
    uv = torch.stack([(j + 0.5) / h, (i + 0.5) / w], -1)
    return rays, uv
