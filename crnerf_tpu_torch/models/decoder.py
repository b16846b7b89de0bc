"""Feature-map -> RGB decoder (``crnerf_tpu/models/decoder.py``
``NeuralRenderer``, ``Blur``, ``PixelShuffleUpsample``). In the shipped
CR-NeRF config the image and feature map are the same size, so n_blocks = 0
and the decoder is one 1x1 conv and a sigmoid. With n_blocks > 0 each block
doubles the map: a pixel-shuffle upsample with a tiled residual and a blur,
a 1x1 conv to the block's width, and an rgb skip that is resized, blurred
and summed block by block (the working dataflow of the reference's
``NeuralRenderer_11``). No system path builds that decoder, as in the JAX
package.

dtypes follow the flax module: ``feat_2_rgb_0`` computes at ``dtype``; the
block convolutions name no dtype, so flax promotes their bf16 inputs to
the fp32 parameters' type and they compute at fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crnerf_tpu_torch.models.common import (
    conv1x1,
    conv2d_deterministic,
    conv2d_ieee,
    leaky_relu,
    nchw,
    nhwc,
    reflect_pad_nchw,
    resize_bilinear,
)


def blur(x: torch.Tensor) -> torch.Tensor:
    """``Blur`` on NHWC: the normalised [1, 2, 1] outer-product kernel,
    depthwise at x's dtype, over a reflection pad of 1."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = ((f[:, None] * f[None, :]) / 16.0).to(x.dtype)
    c = x.shape[-1]
    fn = conv2d_ieee if x.dtype == torch.float32 else conv2d_deterministic
    y = fn(reflect_pad_nchw(nchw(x), 1), k.expand(c, 1, 3, 3).contiguous(),
           None, (1, 1), (0, 0), (1, 1), c)
    return nhwc(y)


def _promoted(x: torch.Tensor) -> torch.dtype:
    """The compute dtype of a flax conv without ``dtype`` on fp32 params."""
    return torch.promote_types(x.dtype, torch.float32)


class PixelShuffleUpsample(nn.Module):
    """2x upsample: two 1x1 convs to 4C with the input tiled 4 times as a
    residual, pixel shuffle, blur."""

    def __init__(self, c_in: int, in_feature: int):
        super().__init__()
        self.layer_1 = nn.Conv2d(c_in, in_feature * 2, 1)
        self.layer_2 = nn.Conv2d(in_feature * 2, in_feature * 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.repeat(1, 1, 1, 4)
        out = leaky_relu(conv1x1(self.layer_1, x, _promoted(x)))
        out = leaky_relu(conv1x1(self.layer_2, out, _promoted(out)))
        out = nhwc(F.pixel_shuffle(nchw(out + y), 2))
        return blur(out)


class NeuralRenderer(nn.Module):
    def __init__(self, feat_nc: int = 64, out_dim: int = 3, n_blocks: int = 0,
                 final_act: str = "sigmoid", min_feat: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if final_act not in ("sigmoid", "tanh01", "none"):
            raise ValueError(f"unknown final_act {final_act!r}")
        self.final_act = final_act
        self.dtype = dtype
        self.n_blocks = n_blocks
        self.feat_2_rgb_0 = nn.Conv2d(feat_nc, out_dim, 1)
        feat = lambda i: max(feat_nc // (2 ** i), min_feat)  # noqa: E731
        for i in range(n_blocks):
            self.add_module(f"upsample_{i}", PixelShuffleUpsample(
                feat_nc if i == 0 else feat(i), feat(i)))
            self.add_module(f"feat_{i}", nn.Conv2d(feat(i), feat(i + 1), 1))
            self.add_module(f"feat_2_rgb_{i + 1}",
                            nn.Conv2d(feat(i + 1), out_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, feat_nc) -> (N, H 2^n_blocks, W 2^n_blocks, out_dim)
        f32."""
        rgb = conv1x1(self.feat_2_rgb_0, x, self.dtype)
        net = x
        for i in range(self.n_blocks):
            up = getattr(self, f"upsample_{i}")(net)
            net = leaky_relu(conv1x1(getattr(self, f"feat_{i}"), up,
                                     _promoted(up)))
            if i == 0:
                # the first rgb is brought to the upsampled size
                rgb = blur(resize_bilinear(rgb, net.shape[1:3]))
            layer = getattr(self, f"feat_2_rgb_{i + 1}")
            rgb = rgb + conv1x1(layer, net, _promoted(net))
            if i < self.n_blocks - 1:
                rgb = blur(resize_bilinear(
                    rgb, (rgb.shape[1] * 2, rgb.shape[2] * 2)))
        rgb = rgb.float()
        if self.final_act == "sigmoid":
            return torch.sigmoid(rgb)
        if self.final_act == "tanh01":
            return (torch.tanh(rgb) + 1.0) / 2.0
        return rgb


def get_renderer(nerf_out_dim: int = 64, model_mode: str = "1-1",
                 n_blocks: int = 0,
                 dtype: torch.dtype = torch.float32) -> NeuralRenderer:
    """Decoder used when encode_a is off (model_mode '1-1' or '1-4-1')."""
    acts = {"1-1": "sigmoid", "1-4-1": "tanh01"}
    if model_mode not in acts:
        raise ValueError(f"unknown model_mode {model_mode!r}")
    return NeuralRenderer(nerf_out_dim, 3, n_blocks, acts[model_mode],
                          dtype=dtype)
