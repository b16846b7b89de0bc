"""Inference-only renderer: the port's system -> full-frame renders
(``crnerf_tpu/render/inference.py`` ``Renderer``).

Camera in, rays and pixel-centre uv made on the device, uint8 out. Frames
render at their exact size: eager PyTorch compiles nothing per shape, so
the JAX package's quarter-octave ray buckets buy nothing here until they
are measured on the card. The style statistics then run over all real
pixels, which is what the bucketed masked statistics compute, and the mask
is gathered at pixel centres as the bucketed route does.

With a process group (``Renderer(group=)``) every rank renders its slice
of a frame's rays and gets the whole frame (``forward_eval_sharded``): the
bits of the single-process render. Every rank makes the same calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from crnerf_tpu_torch.core.rays import cam_rays_uv
from crnerf_tpu_torch.render.system import CrNerfSystem, pixel_uv

_KEEP_KEYS = ("rgb_fine", "rgb_coarse", "depth_fine", "depth_coarse",
              "out_mask")


def select(results: Dict[str, torch.Tensor],
           outputs: str) -> Dict[str, torch.Tensor]:
    """``"full"``: rgb/depth/mask float tensors. ``"rgb_u8"``: only the
    final rgb, quantized on the device exactly as the PNG writer does
    (clip to [0, 1], * 255, truncating cast)."""
    kept = {k: results[k] for k in _KEEP_KEYS if k in results}
    if outputs == "rgb_u8":
        r = kept.get("rgb_fine", kept["rgb_coarse"]).float()
        return {"rgb_u8": (torch.clamp(r, 0.0, 1.0) * 255.0).to(torch.uint8)}
    if outputs != "full":
        raise ValueError(f"unknown outputs {outputs!r}")
    return kept


class Renderer:
    def __init__(self, cfg, system: CrNerfSystem,
                 device: Optional[torch.device] = None, group=None):
        self.cfg = cfg
        self.system = system.eval()
        self.device = device or next(system.parameters()).device
        self.group = group
        self._kernel_weights = None

    def kernel_weights(self):
        """The MLPs in the kernel's layout, prepared on first use and kept:
        a Renderer serves frozen weights (it puts the system in eval mode).
        Build a new Renderer after the weights have changed."""
        if self._kernel_weights is None:
            self._kernel_weights = self.system.kernel_weights()
        return self._kernel_weights

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _dispatch(self, rays, uv, whole_img, hw, outputs) -> Dict:
        args = (rays, uv, self._as_tensor(whole_img), hw,
                self.kernel_weights())
        kw = dict(want_mask=outputs == "full", tile=self.cfg.chunk)
        if self.group is not None:
            res = self.system.forward_eval_sharded(*args, self.group, **kw)
        else:
            res = self.system.forward_eval(*args, **kw)
        return {"dev": select(res, outputs), "hw": tuple(hw)}

    @torch.no_grad()
    def render_frame_async(self, rays, whole_img, hw: Tuple[int, int],
                           outputs: str = "full") -> Dict:
        """Host rays (h*w, 8) in; returns a handle without waiting for the
        device (``fetch`` completes it)."""
        rays = self._as_tensor(rays)[:, :8].contiguous()
        return self._dispatch(rays, pixel_uv(hw, self.device), whole_img,
                              hw, outputs)

    @torch.no_grad()
    def render_frame_cam_async(self, c2w, K, near: float, far: float,
                               hw: Tuple[int, int], whole_img,
                               outputs: str = "full") -> Dict:
        """Camera in: c2w (3, 4), K (3, 3); rays and uv are made on the
        device. ``whole_img`` (1, Ha, Wa, 3) in [-1, 1] may already be a
        device tensor."""
        K = np.asarray(K, np.float32)
        intr = self._as_tensor([K[0][0], K[1][1], K[0][2], K[1][2]])
        rays, uv = cam_rays_uv(self._as_tensor(c2w), intr, near, far, hw)
        return self._dispatch(rays, uv, whole_img, hw, outputs)

    def fetch(self, handle: Dict) -> Dict[str, np.ndarray]:
        """Copy a handle's results to the host, shaped (h, w, ...)."""
        h, w = handle["hw"]
        out = {k: v.cpu().numpy() for k, v in handle["dev"].items()}
        if "rgb_u8" in out:
            return {"rgb_u8": out["rgb_u8"].reshape(h, w, 3)}
        typ = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
        res = {
            "rgb": out[typ].reshape(h, w, 3),
            "depth": out.get("depth_fine",
                             out["depth_coarse"]).reshape(h, w),
        }
        if "out_mask" in out:
            res["mask"] = out["out_mask"].reshape(h, w)
        return res

    def render_frame(self, rays, whole_img, hw: Tuple[int, int],
                     outputs: str = "full") -> Dict[str, np.ndarray]:
        """Synchronous render from host rays."""
        return self.fetch(self.render_frame_async(rays, whole_img, hw,
                                                  outputs))
