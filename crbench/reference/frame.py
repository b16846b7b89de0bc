"""A served frame by the plain reference: camera in, uint8 rgb out."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from crbench.camera import frame_rays
from crbench.reference.model import FP32, Quant, Weights, enc_a, \
    ieee_fp32, style_decode
from crbench.reference.render import render


@torch.no_grad()
def frame_u8(W: Weights, cfg: Dict, c2w, K, near: float, far: float,
             hw: Tuple[int, int], style: np.ndarray, device,
             q: Quant = FP32, block: int = 2048) -> np.ndarray:
    """The (h, w, 3) uint8 frame of camera (c2w, K) in the appearance of
    ``style`` (Ha, Wa, 3) in [-1, 1]: every ray's coarse and fine pass in
    blocks of ``block`` rays, the fine feature map styled by the style
    image's embedding and decoded, quantised as the served PNG is (clip to
    [0, 1], times 255, truncated)."""
    with ieee_fp32():
        rays, _ = frame_rays(c2w, K, near, far, hw, device)
        feats = [render(W, rays[i:i + block], cfg, q)[1]
                 for i in range(0, rays.shape[0], block)]
        fmap = torch.cat(feats, 0).reshape(1, *hw, -1)
        s01 = (torch.as_tensor(style, dtype=torch.float32,
                               device=device)[None] + 1.0) / 2.0
        rgb = style_decode(W, fmap, enc_a(W, "enc_a", s01, q), q)[0]
        u8 = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    return u8.cpu().numpy()
