"""Images without an image library: an 8-bit RGB PNG writer on the
standard library (zlib + struct), shared by the server, the eval app and
the metric logger, and the depth panel's JET colouring
(``crnerf_tpu/utils/visualization.py`` ``visualize_depth``) in numpy, with
cv2's colormap when cv2 imports.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def png_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3) image -> PNG bytes (8-bit RGB, no filtering). uint8
    passes through; float is [0, 1] and quantized like the renderer."""
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected 3 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", crc)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """``png_bytes`` to a file, written tmp + rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png_bytes(rgb))
    os.replace(tmp, path)


def _jet(x: np.ndarray) -> np.ndarray:
    """JET colormap on [0, 1] -> (..., 3) in [0, 1]."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], -1)


def visualize_depth(depth, wh=None) -> np.ndarray:
    """depth (H*W,) or (H, W) -> (H, W, 3) float [0, 1] JET image of the
    min-max normalised depth."""
    d = np.asarray(depth, np.float64)
    if d.ndim == 1:
        if wh is None:
            raise ValueError("flat depth needs wh=(w, h)")
        w, h = wh
        d = d.reshape(h, w)
    lo, hi = np.nanmin(d), np.nanmax(d)
    x = (d - lo) / max(hi - lo, 1e-8)
    try:
        import cv2  # type: ignore
    except ImportError:
        return _jet(x).astype(np.float32)
    m = cv2.applyColorMap((x * 255).astype(np.uint8), cv2.COLORMAP_JET)
    return m[..., ::-1].astype(np.float32) / 255.0
