"""The networks of the plain reference over a dict of named weights
(the names of the system's ``state_dict``), NHWC in and out."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
FP8_MAX = 448.0     # largest finite float8_e4m3fn


@contextlib.contextmanager
def ieee_fp32():
    """Matrix products and convolutions in IEEE float32 inside the block
    (no TF32), the flags restored on leaving."""
    mm, cv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = mm.fp32_precision, cv.fp32_precision
    mm.fp32_precision = cv.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision, cv.fp32_precision = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (its largest value to
    448), back to float32."""
    s = t.detach().abs().amax() / FP8_MAX
    if float(s) == 0.0:
        return t
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Quant:
    """The operands of every product: as they are (``None``, float32) or
    rounded to fp8 on the way in and their gradients on the way back
    (``"fp8"``, the control)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kind is None else _Fp8.apply(t)


FP32 = Quant()


def linear(W: Weights, name: str, x, q: Quant = FP32, bias: bool = True):
    return F.linear(q(x), q(W[name + ".weight"]),
                    W[name + ".bias"] if bias else None)


def conv(W: Weights, name: str, x, q: Quant = FP32, stride=1, padding=0,
         dilation=1, groups=1, bias: bool = True):
    """NCHW convolution with the layer's weights."""
    b = W.get(name + ".bias") if bias else None
    return F.conv2d(q(x), q(W[name + ".weight"]), b, stride, padding,
                    dilation, groups)


def leaky(x):
    return F.leaky_relu(x, 0.2)


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


# -------------------------------------------------------------- NeRF MLP
def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """x (..., 3) -> [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x),
    cos(2^(F-1) x)], float32."""
    freqs = torch.as_tensor(2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs),
                            dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


def nerf_logits(W: Weights, p: str, xyz_emb, dir_emb, depth: int,
                skips: Sequence[int], q: Quant = FP32):
    """-> (features (..., C), sigma (..., 1)) before their activations."""
    h = xyz_emb
    for i in range(depth):
        inp = torch.cat([xyz_emb, h], -1) if i in skips else h
        h = torch.relu(linear(W, f"{p}.xyz_encoding_{i + 1}", inp, q))
    sigma = linear(W, f"{p}.sigma", h, q)
    final = linear(W, f"{p}.xyz_encoding_final", h, q)
    d = torch.relu(linear(W, f"{p}.dir_encoding",
                          torch.cat([final, dir_emb], -1), q))
    return linear(W, f"{p}.feature", d, q), sigma


def nerf(W: Weights, p: str, xyz_emb, dir_emb, depth: int,
         skips: Sequence[int], q: Quant = FP32):
    """-> (features (..., C) in (0, 1), sigma (...))."""
    feat, sigma = nerf_logits(W, p, xyz_emb, dir_emb, depth, skips, q)
    return torch.sigmoid(feat), softplus(sigma)[..., 0]


# -------------------------------------------------- appearance encoder
def enc_a(W: Weights, p: str, x01, q: Quant = FP32, pool_hw: int = 32):
    """(N, H, W, 3) in [0, 1] -> (N, 32, 32, C)."""
    def refl(x, name):
        return conv(W, f"{p}.{name}.Conv_0",
                    F.pad(x, (1, 1, 1, 1), mode="reflect"), q)

    x = conv(W, f"{p}.conv1", nchw(x01), q)
    x = leaky(refl(x, "conv2"))
    x = leaky(refl(x, "conv3"))
    x = F.max_pool2d(x, 2, 2)
    x = leaky(refl(x, "conv4"))
    x = leaky(refl(x, "conv5"))
    x = F.max_pool2d(x, 2, 2)
    x = leaky(refl(x, "conv6"))
    x = F.adaptive_avg_pool2d(x, (pool_hw, pool_hw))
    return nhwc(leaky(conv(W, f"{p}.conv7", x, q)))


# ------------------------------------------------------------------ CGNet
def _norm(W: Weights, p: str, x, train: bool, eps: float = 1e-3):
    """Batch norm: in training each image by its own statistics over H x
    W (the biased variance), else the running statistics."""
    bn = f"{p}._Norm_0.BatchNorm_0"
    if train:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    else:
        mean = W[bn + ".running_mean"][None, :, None, None]
        var = W[bn + ".running_var"][None, :, None, None]
    return ((x - mean) * torch.rsqrt(var + eps)
            * W[bn + ".weight"][None, :, None, None]
            + W[bn + ".bias"][None, :, None, None])


def _prelu(W: Weights, p: str, x):
    a = W[f"{p}.PReLU_0.weight"][None, :, None, None]
    return torch.where(x >= 0, x, a * x)


def _cbr(W, p, x, k, stride, train, q):
    x = conv(W, f"{p}.Conv_0", x, q, stride, (k - 1) // 2, bias=False)
    return _prelu(W, p, _norm(W, p, x, train))


def _dw(W, p, x, dil, q):
    return conv(W, p, x, q, 1, dil, dil, x.shape[1], bias=False)


def _fglo(W, p, x, q):
    y = x.mean(dim=(2, 3))
    y = torch.sigmoid(linear(W, f"{p}.Dense_1",
                             torch.relu(linear(W, f"{p}.Dense_0", y, q)), q))
    return x * y[:, :, None, None]


def _down(W, p, x, dil, train, q):
    x = _cbr(W, f"{p}.conv1x1", x, 3, 2, train, q)
    joi = torch.cat([_dw(W, f"{p}.F_loc", x, 1, q),
                     _dw(W, f"{p}.F_sur", x, dil, q)], 1)
    joi = _prelu(W, p, _norm(W, p, joi, train))
    return _fglo(W, f"{p}.FGlo_0",
                 conv(W, f"{p}.reduce", joi, q, bias=False), q)


def _block(W, p, x, dil, train, q):
    h = _cbr(W, f"{p}.conv1x1", x, 1, 1, train, q)
    joi = torch.cat([_dw(W, f"{p}.F_loc", h, 1, q),
                     _dw(W, f"{p}.F_sur", h, dil, q)], 1)
    joi = _prelu(W, f"{p}.bn_prelu", _norm(W, f"{p}.bn_prelu", joi, train))
    return x + _fglo(W, f"{p}.FGlo_0", joi, q)


def cgnet(W: Weights, p: str, x01, train: bool, q: Quant = FP32):
    """The CGNet mask (classes 1, M = N = 2): (N, H, W, 3) -> (N, H, W, 1)
    in (0, 1)."""
    hw = x01.shape[1:3]
    x = nchw(x01)
    out0 = _cbr(W, f"{p}.level1_0", x, 3, 2, train, q)
    out0 = _cbr(W, f"{p}.level1_1", out0, 3, 1, train, q)
    out0 = _cbr(W, f"{p}.level1_2", out0, 3, 1, train, q)
    inp1 = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
    inp2 = F.avg_pool2d(inp1, 3, 2, 1, count_include_pad=True)

    def bn_prelu(name, t):
        return _prelu(W, f"{p}.{name}", _norm(W, f"{p}.{name}", t, train))

    cat0 = bn_prelu("b1", torch.cat([out0, inp1], 1))
    out1_0 = _down(W, f"{p}.level2_0", cat0, 2, train, q)
    out1 = _block(W, f"{p}.level2_1", out1_0, 2, train, q)
    cat1 = bn_prelu("bn_prelu_2", torch.cat([out1, out1_0, inp2], 1))
    out2_0 = _down(W, f"{p}.level3_0", cat1, 4, train, q)
    out2 = _block(W, f"{p}.level3_1", out2_0, 4, train, q)
    cat2 = bn_prelu("bn_prelu_3", torch.cat([out2_0, out2], 1))
    logits = conv(W, f"{p}.classifier", cat2, q)
    up = F.interpolate(logits, size=tuple(hw), mode="bilinear",
                       align_corners=False)
    return nhwc(torch.sigmoid(up))


def sample_bilinear_uv(img, uv):
    """img (H, W, C) at pixel-centre (v, u) in [0, 1) -> (N, C), bilinear
    with half-pixel centres, edges clamped."""
    h, w, _ = img.shape
    y, x = uv[:, 0] * h - 0.5, uv[:, 1] * w - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = (y - y0)[:, None], (x - x0)[:, None]

    def at(yy, xx):
        return img[yy.long().clamp(0, h - 1), xx.long().clamp(0, w - 1)]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


# --------------------------------------------------------------- StyleNet
def _conv1x1(W, name, x, q):
    """A 1x1 convolution on NHWC as the matrix product it is."""
    return F.linear(q(x), q(W[name + ".weight"][:, :, 0, 0]),
                    W[name + ".bias"])


def _gram(W, p, x, q, m: int = 32):
    n, h, w, _ = x.shape
    x = leaky(_conv1x1(W, f"{p}.conv1", x, q))
    x = leaky(_conv1x1(W, f"{p}.conv2", x, q))
    flat = _conv1x1(W, f"{p}.conv3", x, q).reshape(n, h * w, m)
    gram = torch.bmm(q(flat.transpose(1, 2)), q(flat)) / (h * w)
    return linear(W, f"{p}.fc", gram.reshape(n, -1), q).reshape(n, m, m)


def decode_rgb(W: Weights, x, q: Quant = FP32):
    """The decoder: one 1x1 convolution to rgb and a sigmoid."""
    return torch.sigmoid(_conv1x1(W, "decoder.decoder.feat_2_rgb_0", x, q))


def style_terms(W: Weights, content, style, q: Quant = FP32, m: int = 32):
    """StyleNet's two terms before ``unzip``: the content ``content`` (N,
    h, w, C) transformed by the grams of it and of ``style`` (N, 32, 32,
    C) -> (N, h, w, m), and the style's mean (N, 1, 1, C)."""
    p = "decoder.multi_net"
    n, h, w, _ = content.shape
    c_f = content - content.mean(dim=(1, 2), keepdim=True)
    s_mean = style.mean(dim=(1, 2), keepdim=True)
    s_f = style - s_mean
    cc = _conv1x1(W, f"{p}.compress", c_f, q)
    trans = torch.bmm(q(_gram(W, f"{p}.snet", s_f, q, m)),
                      q(_gram(W, f"{p}.cnet", c_f, q, m)))
    fused = torch.bmm(q(cc.reshape(n, h * w, m)), q(trans.transpose(1, 2)))
    return fused.reshape(n, h, w, m), s_mean


def style_decode(W: Weights, content, style, q: Quant = FP32, m: int = 32):
    """StyleNet: ``content`` (N, h, w, C) styled by ``style`` (N, 32, 32, C)
    and decoded -> (N, h, w, 3)."""
    fused, s_mean = style_terms(W, content, style, q, m)
    out = _conv1x1(W, "decoder.multi_net.unzip", fused, q) + s_mean
    return decode_rgb(W, out, q)
