"""Shared building blocks (``crnerf_tpu/models/common.py``), only what the
serving path uses. Public functions take and return NHWC tensors, as the
JAX package's do, and are held to them by the tests; the modules, which run
NCHW between their layers, call the same torch operators directly.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel PReLU (torch ``nn.PReLU(C)`` semantics, init 0.25) on
    NCHW input; ``weight`` is the flax module's ``alpha``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[None, :, None, None] * x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: the slope is rounded to x's dtype first (a
    Python scalar takes the array's dtype in JAX), so at bf16 the product
    is bf16(0.2) * x, rounded once."""
    slope = float(torch.tensor(slope, dtype=x.dtype))
    return F.leaky_relu(x, negative_slope=slope)


def reflect_index(n: int, p: int) -> List[int]:
    """The source entry of each of the ``n + 2p`` entries of an axis of
    size ``n`` reflected by ``p`` at both ends: numpy's ``reflect`` mode
    (``np.pad(np.arange(n), p, mode="reflect")``), which repeats a size-1
    axis and, where ``p > n - 1``, reflects again with period
    ``2 (n - 1)``."""
    if n == 1:
        return [0] * (n + 2 * p)
    per = 2 * (n - 1)
    return [j if j < n else per - j
            for j in ((i % per) for i in range(-p, n + p))]


@functools.lru_cache(maxsize=None)
def _reflect_gather(n: int, p: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(reflect_index(n, p), dtype=torch.int64,
                        device=device)


def _fold_reflect(g: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """The adjoint of reflecting ``p`` entries onto each end of ``dim``:
    the interior of ``g``, each border entry added onto the entry it
    copies, left border then right, in index order."""
    n = g.shape[dim] - 2 * p
    out = g.narrow(dim, p, n).clone()
    src = reflect_index(n, p)
    for k in [*range(p), *range(p + n, n + 2 * p)]:
        out.narrow(dim, src[k], 1).add_(g.narrow(dim, k, 1))
    return out


class _ReflectPad2d(torch.autograd.Function):
    """Reflection padding of NCHW H and W by ``reflect_index`` (numpy's
    rule for every size and pad; ``F.pad(mode="reflect")`` refuses a pad
    not below the size), gathered along each axis, with a backward that
    folds the border back in a fixed order. The CUDA backward of
    ``reflection_pad2d`` adds with atomics: a corner entry takes four
    terms, so its gradient changes bits from run to run."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        _, _, h, w = x.shape
        x = x.index_select(2, _reflect_gather(h, p, x.device))
        return x.index_select(3, _reflect_gather(w, p, x.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _fold_reflect(_fold_reflect(g, ctx.p, 3), ctx.p, 2), None


def reflect_pad_nchw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """NCHW reflection padding of H and W (``jnp.pad(mode="reflect")``; for
    ``pad`` below the size ``nn.ReflectionPad2d``), the same bits forward
    and backward from run to run."""
    return _ReflectPad2d.apply(x, pad)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """NHWC reflection padding of H and W (``jnp.pad(mode="reflect")``)."""
    return nhwc(reflect_pad_nchw(nchw(x), pad))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2), floor: an odd trailing row/column is dropped."""
    return nhwc(F.max_pool2d(nchw(x), 2, 2))


def avg_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1), count_include_pad=True."""
    return nhwc(F.avg_pool2d(nchw(x), 3, 2, 1, count_include_pad=True))


def _bin_matrix(size: int, out: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """(out, size): row i averages [floor(i*S/O), ceil((i+1)*S/O))."""
    m = torch.zeros((out, size), dtype=torch.float32)
    for i in range(out):
        s, e = (i * size) // out, -((-(i + 1) * size) // out)
        m[i, s:e] = 1.0 / (e - s)
    return m.to(dtype).float().to(device)


def adaptive_avg_pool2d_nchw(x: torch.Tensor,
                             out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` as the JAX package computes it: two
    contractions with bin-average matrices held at x's dtype (at bf16 a
    1/3 weight is bf16(1/3)), summed in fp32, cast back to x's dtype."""
    _, _, h, w = x.shape
    eh = _bin_matrix(h, out_hw[0], x.dtype, x.device)
    ew = _bin_matrix(w, out_hw[1], x.dtype, x.device)
    y = torch.einsum("oh,nchw->ncow", eh, x.float())
    return torch.einsum("pw,ncow->ncop", ew, y).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    return nhwc(adaptive_avg_pool2d_nchw(nchw(x), out_hw))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres, no antialiasing. Equal to
    ``jax.image.resize(method='bilinear')`` when upsampling (the only use on
    the serving path: CGNet's logits back to the input size); JAX
    antialiases when downsampling and this does not."""
    return nhwc(_ResizeBilinear.apply(nchw(x), tuple(out_hw)))


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(out: int, size: int,
                     device: torch.device) -> torch.Tensor:
    """(out, size) float64: row i holds the two weights with which
    ``F.interpolate(mode="bilinear", align_corners=False)`` reads output
    entry i from the input, made on ``device`` (no copy from the host) once
    a shape: a step's backward would otherwise launch its ~12 kernels."""
    src = ((torch.arange(out, dtype=torch.float64, device=device) + 0.5)
           * (size / out) - 0.5).clamp_min(0.0)
    i0 = src.floor().clamp_max(size - 1)
    i1 = (i0 + 1).clamp_max(size - 1)
    l1 = (src - i0)[:, None]
    cols = torch.arange(size, dtype=torch.float64, device=device)[None]
    return ((cols == i0[:, None]) * (1.0 - l1)
            + (cols == i1[:, None]) * l1)


class _ResizeBilinear(torch.autograd.Function):
    """``F.interpolate(mode="bilinear")`` of NCHW with a backward that is the
    same bits from run to run: the adjoint as two float64 products with
    the interpolation matrices. The CUDA backward of
    ``upsample_bilinear2d`` adds with atomics."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = x.shape[2:]
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (h, w), (ho, wo) = ctx.in_hw, g.shape[2:]
        my = _bilinear_matrix(ho, h, g.device)
        mx = _bilinear_matrix(wo, w, g.device)
        return (my.t() @ (g.double() @ mx)).to(g.dtype), None


def sample_bilinear_uv(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at normalized (v, u) coords (N, 2) in [0, 1)
    with half-pixel centres: the value interpolate-then-index gives at
    those pixels, without the full-resolution map."""
    h, w, _ = img.shape
    y = uv[:, 0] * h - 0.5
    x = uv[:, 1] * w - 0.5
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xx = torch.clamp(xx.to(torch.int64), 0, w - 1)
        return img[yy, xx]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


@contextlib.contextmanager
def ieee_fp32_conv():
    """cuDNN's fp32 convolutions in IEEE fp32 inside the block, whatever
    the process's TF32 flags (PyTorch's default lets cuDNN run them in
    TF32, about three decimal digits); the operator's flag is restored on
    leaving, exception or not. Sets the convolution's own flag,
    ``torch.backends.cudnn.conv.fp32_precision``: ``cudnn.flags()`` would
    also turn cuDNN off (its ``enabled`` defaults to False), and reading the
    legacy ``cudnn.allow_tf32`` raises once a caller has set the operators'
    flags apart."""
    flag = torch.backends.cudnn.conv
    saved = flag.fp32_precision
    flag.fp32_precision = "ieee"
    try:
        yield
    finally:
        flag.fp32_precision = saved


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms inside the block; the flag
    is restored on leaving, exception or not. Left free, cuDNN picks for
    some fp32 weight gradients an algorithm that adds with atomics
    (``wgrad_alg0_engine`` on an H100), and a training step's gradients
    change bits from run to run."""
    flags = torch.backends.cudnn
    saved = flags.deterministic
    flags.deterministic = True
    try:
        yield
    finally:
        flags.deterministic = saved


class _Conv2d(torch.autograd.Function):
    """F.conv2d with its backward under ``deterministic_cudnn``, so the
    gradients keep their bits from run to run; with ``ieee`` both the
    forward and the backward also run under ``ieee_fp32_conv`` (autograd
    runs a backward after the forward's block has closed, so pinning the
    forward alone would leave the gradients in TF32)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups,
                ieee):
        ctx.save_for_backward(x, weight)
        ctx.conf = (None if bias is None else list(bias.shape), stride,
                    padding, dilation, groups, ieee)
        with ieee_fp32_conv() if ieee else contextlib.nullcontext():
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        bias_sizes, stride, padding, dilation, groups, ieee = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_sizes is not None and ctx.needs_input_grad[2]]
        with (ieee_fp32_conv() if ieee else contextlib.nullcontext()), \
                deterministic_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, weight, bias_sizes, list(stride), list(padding),
                list(dilation), False, [0] * len(stride), groups, mask)
        return gx, gw, gb, None, None, None, None, None


def conv2d_ieee(x: torch.Tensor, weight: torch.Tensor,
                bias, stride, padding, dilation,
                groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` (numeric stride, padding and dilation tuples) in IEEE
    fp32 on the card, forward and backward, with a backward of the same
    bits from run to run; the same operators as ``F.conv2d`` and its
    autograd backward on the CPU."""
    return _Conv2d.apply(x, weight, bias, tuple(stride), tuple(padding),
                         tuple(dilation), groups, True)


def conv2d_deterministic(x: torch.Tensor, weight: torch.Tensor,
                         bias, stride, padding, dilation,
                         groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` at the process's precision flags, with a backward of
    the same bits from run to run."""
    return _Conv2d.apply(x, weight, bias, tuple(stride), tuple(padding),
                         tuple(dilation), groups, False)


class IEEEConv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding) through ``conv2d_ieee``: the same
    parameters and names, no TF32 at fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_ieee(x, self.weight, self.bias, self.stride,
                           self.padding, self.dilation, self.groups)


def conv(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dt)`` on NCHW: input and kernel cast to dt, the
    product rounded to dt, then the bias added at dt (two roundings, as in
    flax; a fused bias would round once). At fp32 the product is IEEE fp32
    (``conv2d_ieee``), as the JAX package computes it on the CPU; at any
    dtype the backward keeps its bits from run to run."""
    fn = conv2d_ieee if dt == torch.float32 else conv2d_deterministic
    y = fn(x.to(dt), layer.weight.to(dt), None, layer.stride, layer.padding,
           layer.dilation, layer.groups)
    return y if layer.bias is None else y + layer.bias.to(dt)[:, None, None]


def conv1x1(layer: nn.Conv2d, x: torch.Tensor,
            dt: torch.dtype) -> torch.Tensor:
    """A 1x1 ``nn.Conv(dtype=dt)`` on NHWC, as the matrix product it is,
    with the bias added after the rounding as in ``conv``."""
    y = F.linear(x.to(dt), layer.weight[:, :, 0, 0].to(dt))
    return y if layer.bias is None else y + layer.bias.to(dt)


class ConvRefl(nn.Module):
    """Reflection pad + VALID conv (flax ``ConvRefl``: child ``Conv_0``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3):
        super().__init__()
        self.pad = (kernel - 1) // 2
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """NCHW in, NCHW out."""
        if self.pad:
            x = reflect_pad_nchw(x, self.pad)
        return conv(self.Conv_0, x, dt)
