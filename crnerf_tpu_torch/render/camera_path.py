"""Parametric camera paths for the demo renders, a copy of
``crnerf_tpu/render/camera_path.py`` (which cannot be imported without jax:
``crnerf_tpu/render/__init__.py`` imports the JAX renderer).

A ``PathSpec`` holds per-axis lists of linspace segments for the
translation offsets and the euler-angle ramp around an anchor pose; the
presets are the reference demos' motions with their appearance-source and
pose-anchor picks. ``poses`` works in float64 and casts to float32 at the
end, as the JAX package does, so the two give the same poses bit for bit.
Intrinsics are a fov-60 pinhole at the requested size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from crnerf_tpu_torch.core.rays import get_ray_directions_np, make_ray_buffer

Segment = Tuple[float, float, float]  # (start, end, fraction_of_frames)


def euler_to_rotmat(theta: Sequence[float]) -> np.ndarray:
    """Rx(θx) @ Ry(θy) @ Rz(θz), float64."""
    cx, sx = math.cos(theta[0]), math.sin(theta[0])
    cy, sy = math.cos(theta[1]), math.sin(theta[1])
    cz, sz = math.cos(theta[2]), math.sin(theta[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def piecewise_linspace(segments: Sequence[Segment], n: int) -> np.ndarray:
    """Concatenate linspace segments; fractions are of n and the final
    segment absorbs rounding remainder."""
    if not segments:
        return np.zeros(n)
    counts = [int(n * frac) for (_, _, frac) in segments[:-1]]
    counts.append(n - sum(counts))
    return np.concatenate([
        np.linspace(s, e, c) for (s, e, _), c in zip(segments, counts)
    ])


@dataclasses.dataclass(frozen=True)
class PathSpec:
    dx: Sequence[Segment] = ()
    dy: Sequence[Segment] = ()
    dz: Sequence[Segment] = ()
    theta_x: Sequence[Segment] = ()
    theta_y: Sequence[Segment] = ()
    theta_z: Sequence[Segment] = ()
    n_frames: int = 240  # 30 fps x 8 s in the reference demos
    appearance_train_idx: Optional[int] = None  # appearance-source image
    # the pose anchor, when it is not the appearance source: an image id
    # or an index into the train images
    pose_image_id: Optional[int] = None
    pose_train_idx: Optional[int] = None

    def poses(self, anchor_c2w: np.ndarray) -> np.ndarray:
        """(n_frames, 3, 4) float32 camera path around the anchor pose."""
        n = self.n_frames
        dx = piecewise_linspace(self.dx, n)
        dy = piecewise_linspace(self.dy, n)
        dz = piecewise_linspace(self.dz, n)
        tx = piecewise_linspace(self.theta_x, n)
        ty = piecewise_linspace(self.theta_y, n)
        tz = piecewise_linspace(self.theta_z, n)
        out = np.tile(np.asarray(anchor_c2w, np.float64), (n, 1, 1))
        out[:, 0, 3] += dx
        out[:, 1, 3] += dy
        out[:, 2, 3] += dz
        for i in range(n):
            out[i, :, :3] = euler_to_rotmat((tx[i], ty[i], tz[i])) @ (
                out[i, :, :3]
            )
        return out.astype(np.float32)


def fov_intrinsics(img_wh: Tuple[int, int],
                   fov_deg: float = 60.0) -> np.ndarray:
    """Pinhole K with horizontal fov (reference test_K, eval.py:135-139)."""
    w, h = img_wh
    focal = w / 2 / math.tan(math.radians(fov_deg) / 2)
    return np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
    )


_PI = math.pi

PATH_PRESETS: Dict[str, PathSpec] = {
    "brandenburg_gate": PathSpec(
        # the reference's dx has 360 entries, of which its 240 frames use
        # the first linspace
        dx=[(-0.25, 0.25, 1.0)],
        dy=[(0.05, -0.1, 0.5), (-0.1, 0.05, 0.5)],
        dz=[(0.1, 0.3, 0.5), (0.3, 0.1, 0.5)],
        theta_x=[(_PI / 30, 0.0, 0.5), (0.0, _PI / 30, 0.5)],
        theta_y=[(_PI / 10, -_PI / 10, 1.0)],
        appearance_train_idx=314,
        pose_image_id=1123,
    ),
    "trevi_fountain": PathSpec(
        dx=[(-0.8, 0.7, 1.0)],
        dy=[(0.0, 0.05, 0.5), (0.05, 0.0, 0.5)],
        dz=[(0.4, 0.1, 0.25), (0.1, 0.5, 0.25),
            (0.5, 0.1, 0.25), (0.1, 0.4, 0.25)],
        theta_y=[(_PI / 6, -_PI / 6, 1.0)],
        appearance_train_idx=1548,
        pose_train_idx=1548,
    ),
    "sacre_coeur": PathSpec(
        dx=[(-2.0, 2.0, 1.0)],
        dy=[(0.0, 2.0, 0.5), (2.0, 0.0, 0.5)],
        dz=[(0.0, -3.0, 0.5), (-3.0, 0.0, 0.5)],
        theta_y=[(_PI / 6, -_PI / 6, 1.0)],
        appearance_train_idx=58,
        pose_train_idx=99,
    ),
}

# anchor poses of the stand-alone video demo, which runs without COLMAP
# data
DEMO_ANCHORS: Dict[str, np.ndarray] = {
    "brandenburg_gate": np.array(
        [[0.997, 0.0017, -0.077, 0.0355],
         [0.0108, -0.9929, 0.1181, 0.0234],
         [-0.0763, -0.1186, -0.9900, 0.1216]], np.float32
    ),
    "trevi_fountain": np.array(
        [[0.9997, -0.0049, -0.0232, -0.0266],
         [-0.0065, -0.9974, -0.0712, -0.0007],
         [-0.0228, 0.0713, -0.9972, 0.0008]], np.float32
    ),
}


def resolve_scene(scene_name: str) -> str:
    """The preset a scene name ends with or contains
    ('..._brandenburg_gate')."""
    for key in PATH_PRESETS:
        if scene_name.endswith(key) or key in scene_name:
            return key
    raise KeyError(
        f"no camera-path preset for scene {scene_name!r}; "
        f"available: {sorted(PATH_PRESETS)}"
    )


def test_path_rays(
    spec: PathSpec,
    anchor_c2w: np.ndarray,
    img_wh: Tuple[int, int],
    near: float,
    far: float,
    fov_deg: float = 60.0,
):
    """Yield the (h*w, 8) host rays of each path frame."""
    K = fov_intrinsics(img_wh, fov_deg)
    w, h = img_wh
    dirs = get_ray_directions_np(h, w, K)
    for c2w in spec.poses(anchor_c2w):
        yield make_ray_buffer(dirs, c2w, near, far, 0)[:, :8]
