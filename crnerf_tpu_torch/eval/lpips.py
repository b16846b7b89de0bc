"""LPIPS, AlexNet variant (``crnerf_tpu/eval/lpips.py`` ``LpipsAlex``):
the reference's perceptual score (the ``lpips`` package's ``net="alex"``;
Zhang et al., CVPR 2018).

The AlexNet conv trunk with a 3x3 / stride-2 max pool after its first two
convolutions, each of its five ReLU outputs normalised to unit length over
the channels, the squared difference of the two images' taps weighted by
the learned non-negative 1x1 heads, averaged over space and summed over the
taps.

The trained weights are not in the repo and cannot be fetched here. They
are read from an npz in the JAX package's layout (``conv{i}_w`` HWIO,
``conv{i}_b``, ``lin{i}_w`` (C,)), by default ``<repo>/weights/
lpips_alex.npz``, the file the JAX package reads;
``scripts/export_lpips_weights.py`` writes it where the ``lpips`` package
is installed. Without it the class raises ``FileNotFoundError``. The
convolutions run in IEEE fp32 on the card (no TF32).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from crnerf_tpu_torch.models.common import conv2d_ieee

# AlexNet's conv trunk: (out channels, kernel, stride, pad)
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
_N_TAPS = 5

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "weights", "lpips_alex.npz")


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LpipsAlex:
    """Callable: (pred01, gt01) HWC or NHWC float in [0, 1], numpy or
    tensors -> the mean LPIPS over the batch, a float."""

    def __init__(self, weights: Optional[str] = None,
                 device: torch.device = torch.device("cpu")):
        path = weights or DEFAULT_WEIGHTS
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}; convert them with "
                "scripts/export_lpips_weights.py on a machine with the "
                "'lpips' package")
        self.device = torch.device(device)
        with np.load(path) as z:
            t = lambda a: torch.as_tensor(  # noqa: E731
                np.asarray(a, np.float32), device=self.device)
            # HWIO -> OIHW
            self.conv_w = [t(z[f"conv{i}_w"]).permute(3, 2, 0, 1)
                           .contiguous() for i in range(len(_ALEX_CONVS))]
            self.conv_b = [t(z[f"conv{i}_b"])
                           for i in range(len(_ALEX_CONVS))]
            self.lin_w = [t(z[f"lin{i}_w"]) for i in range(_N_TAPS)]
        self.shift = torch.tensor(_SHIFT, device=self.device)[:, None, None]
        self.scale = torch.tensor(_SCALE, device=self.device)[:, None, None]

    def _features(self, x01: torch.Tensor):
        """(N, 3, H, W) in [0, 1] -> the five ReLU taps."""
        x = (x01 * 2.0 - 1.0 - self.shift) / self.scale
        taps = []
        for i, (_, _, s, p) in enumerate(_ALEX_CONVS):
            x = torch.relu(conv2d_ieee(x, self.conv_w[i], self.conv_b[i],
                                       (s, s), (p, p), (1, 1)))
            taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return taps

    @torch.no_grad()
    def __call__(self, pred01, gt01) -> float:
        p = torch.as_tensor(pred01, dtype=torch.float32, device=self.device)
        g = torch.as_tensor(gt01, dtype=torch.float32, device=self.device)
        if p.dim() == 3:
            p, g = p[None], g[None]
        t_p = self._features(p.permute(0, 3, 1, 2))
        t_g = self._features(g.permute(0, 3, 1, 2))
        total = 0.0
        for i in range(_N_TAPS):
            d = (_unit_normalize(t_p[i]) - _unit_normalize(t_g[i])) ** 2
            total = total + torch.einsum("nchw,c->nhw", d,
                                         self.lin_w[i]).mean(dim=(1, 2))
        return float(total.mean())
