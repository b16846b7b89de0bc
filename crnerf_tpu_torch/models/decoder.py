"""Feature-map -> RGB decoder (``crnerf_tpu/models/decoder.py``
``NeuralRenderer``). In the shipped CR-NeRF config the image and feature
map are the same size, so n_blocks = 0 and the decoder is one 1x1 conv and
a sigmoid; the progressive-upsampling blocks are not on the serving path
and are not ported."""

from __future__ import annotations

import torch
from torch import nn

from crnerf_tpu_torch.models.common import conv1x1


class NeuralRenderer(nn.Module):
    def __init__(self, feat_nc: int = 64, out_dim: int = 3, n_blocks: int = 0,
                 final_act: str = "sigmoid",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_blocks != 0:
            raise NotImplementedError(
                "only the pointwise n_blocks=0 decoder is ported")
        if final_act not in ("sigmoid", "tanh01"):
            raise ValueError(f"unknown final_act {final_act!r}")
        self.final_act = final_act
        self.dtype = dtype
        self.feat_2_rgb_0 = nn.Conv2d(feat_nc, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, feat_nc) -> (N, H, W, 3) f32."""
        rgb = conv1x1(self.feat_2_rgb_0, x, self.dtype).float()
        if self.final_act == "sigmoid":
            return torch.sigmoid(rgb)
        return (torch.tanh(rgb) + 1.0) / 2.0


def get_renderer(nerf_out_dim: int = 64, model_mode: str = "1-1",
                 dtype: torch.dtype = torch.float32) -> NeuralRenderer:
    """Decoder used when encode_a is off (model_mode '1-1' or '1-4-1')."""
    acts = {"1-1": "sigmoid", "1-4-1": "tanh01"}
    if model_mode not in acts:
        raise ValueError(f"unknown model_mode {model_mode!r}")
    return NeuralRenderer(nerf_out_dim, 3, 0, acts[model_mode], dtype)
