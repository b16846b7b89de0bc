"""The cross-ray style transformation head (``crnerf_tpu/models/style.py``):
``GramCNN``, ``StyleTransform``, ``StyleNet``.

Content (rendered feature map) and style embedding are mean-centred,
compressed to ``matrix_size`` channels, turned into gram-like matrices by
1x1 conv towers, multiplied into one transformation matrix, applied to the
compressed content, unzipped and shifted by the style mean. The gram and
transformation products stay fp32 (matmuls, never TF32 on the card: the
caller leaves ``torch.backends.cuda.matmul.allow_tf32`` at its default,
False).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from crnerf_tpu_torch.models.common import conv1x1, leaky_relu
from crnerf_tpu_torch.models.decoder import NeuralRenderer


class GramCNN(nn.Module):
    """1x1 conv tower + gram matrix + FC: NHWC -> (N, m*m)."""

    def __init__(self, matrix_size: int = 32, in_channel: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.m = matrix_size
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channel, 128, 1)
        self.conv2 = nn.Conv2d(128, 64, 1)
        self.conv3 = nn.Conv2d(64, matrix_size, 1)
        self.fc = nn.Linear(matrix_size * matrix_size,
                            matrix_size * matrix_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        dt = self.dtype
        x = leaky_relu(conv1x1(self.conv1, x, dt))
        x = leaky_relu(conv1x1(self.conv2, x, dt))
        x = conv1x1(self.conv3, x, dt).float()
        flat = x.reshape(n, h * w, self.m)
        gram = torch.bmm(flat.transpose(1, 2), flat) / (h * w)
        return F.linear(gram.reshape(n, -1), self.fc.weight, self.fc.bias)


class StyleTransform(nn.Module):
    def __init__(self, matrix_size: int = 32, in_channel: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.m = matrix_size
        self.dtype = dtype
        self.compress = nn.Conv2d(in_channel, matrix_size, 1)
        self.unzip = nn.Conv2d(matrix_size, in_channel, 1)
        self.cnet = GramCNN(matrix_size, in_channel, dtype)
        self.snet = GramCNN(matrix_size, in_channel, dtype)

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content (N, Hc, Wc, C), style (N, Hs, Ws, C) ->
        (fused (N, Hc, Wc, C), transmatrix (N, m, m))."""
        m = self.m
        n, ch, cw, _ = content.shape
        c_mean = torch.mean(content, dim=(1, 2), keepdim=True)
        c_f = content - c_mean
        s_mean = torch.mean(style, dim=(1, 2), keepdim=True)
        s_f = style - s_mean
        cc = conv1x1(self.compress, c_f, self.dtype)
        c_mat = self.cnet(c_f).reshape(n, m, m)
        s_mat = self.snet(s_f).reshape(n, m, m)
        trans = torch.bmm(s_mat, c_mat).to(content.dtype)
        fused = torch.bmm(cc.reshape(n, ch * cw, m).float(),
                          trans.float().transpose(1, 2))
        fused = fused.to(content.dtype).reshape(n, ch, cw, m)
        return conv1x1(self.unzip, fused, self.dtype) + s_mean, trans


class StyleNet(nn.Module):
    """Fusion + decode (``style_net``). ``style=None, kind="content"``
    decodes the raw feature map, unstyled, for the content-constraint
    loss. ``n_upsample_blocks``: the decoder's blocks (0 in the shipped
    config)."""

    def __init__(self, nerf_out_dim: int = 64, n_upsample_blocks: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.multi_net = StyleTransform(in_channel=nerf_out_dim, dtype=dtype)
        self.decoder = NeuralRenderer(feat_nc=nerf_out_dim, out_dim=3,
                                      n_blocks=n_upsample_blocks,
                                      dtype=dtype)

    def forward(self, content: torch.Tensor,
                style: Optional[torch.Tensor] = None,
                kind: Optional[str] = None) -> torch.Tensor:
        if style is None and kind == "content":
            return self.decoder(content)
        fused, _ = self.multi_net(content, style)
        return self.decoder(fused)

    def decode_batch(self, contents: torch.Tensor, styles: torch.Tensor,
                     raw_extra: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """``contents`` (K, H, W, C) styled by ``styles`` (K, 32, 32, C),
        with ``raw_extra`` (M, H, W, C) appended unstyled (the content
        path), in one StyleTransform and one decoder pass -> (K + M, H', W',
        3). The style statistics and the convolutions are per sample, so
        this is K + M separate decodes."""
        fused, _ = self.multi_net(contents, styles)
        if raw_extra is not None:
            fused = torch.cat([fused, raw_extra], 0)
        return self.decoder(fused)
