"""Lanczos resize of 8-bit images without an image library: the bytes of
``PIL.Image.resize(size, Image.LANCZOS)`` (Pillow's ``Resample.c``).

Two separable passes, horizontal first with an 8-bit intermediate, then
vertical. Each output sample is a Lanczos (a = 3) weighting of the input
samples within the filter's support, widened by the scale when the image
shrinks. The weights are normalised in double precision, quantised to
fixed point with 22 fraction bits, summed as integers from a half-unit
bias, shifted back and clipped to 0..255. Here a pass sums, tap by tap,
the weight times the input row (or column) that tap reads for every output
at once, in int32 as Pillow sums (the weights of one output add to about
2^22 in magnitude, so no sum leaves int32).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_SUPPORT = 3.0
_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def resample_taps(in_size: int, out_size: int):
    """One pass's fixed-point weights (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``) -> (first (out,) input index of each
    output, weights (out, taps) int32, zero past an output's last
    input)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = [_lanczos((x - center + 0.5) / filterscale)
             for x in range(xmin, xmax)]
        ww = sum(k)
        first[xx] = xmin
        for i, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            weights[xx, i] = int((0.5 if w >= 0 else -0.5)
                                 + w * (1 << _PRECISION_BITS))
    return first, weights


def _pass(rows: np.ndarray, out_size: int) -> np.ndarray:
    """rows (n, ...) uint8 resampled along axis 0 -> (out_size, ...)
    uint8."""
    first, weights = resample_taps(rows.shape[0], out_size)
    src = np.ascontiguousarray(rows, dtype=np.int32)
    extra = (1,) * (rows.ndim - 1)
    acc = np.full((out_size,) + rows.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, rows.shape[0] - 1)
        acc += weights[:, j].reshape(-1, *extra) * src[idx]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(img: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8, as Pillow's LANCZOS
    resize of that image. A pass whose size does not change is skipped, as
    Pillow skips it."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {img.dtype} "
                         f"{img.shape}")
    out_w, out_h = (int(v) for v in out_wh)
    h, w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"output size must be positive, got {out_wh}")
    if out_w != w:
        img = _pass(img.transpose(1, 0, 2), out_w).transpose(1, 0, 2)
    if out_h != h:
        img = _pass(img, out_h)
    return np.ascontiguousarray(img)
