"""Depth panels and videos without an image library
(``crnerf_tpu/utils/visualization.py``).

``visualize_depth`` colours a depth map with JET in numpy (cv2's colormap
when cv2 imports). ``write_video`` writes frames as an animated GIF with a
GIF89a writer on the standard library and numpy, where the JAX package
calls ``imageio.mimsave``:

- the container: a NETSCAPE2.0 block that loops forever, a delay of
  ``round(100 / fps)`` centiseconds and a local colour table a frame;
- the palette: each frame is reduced to the fixed 6 x 7 x 6 colour cube
  (252 colours), every channel rounded to its nearest level, so that no
  channel of a frame moves by more than ``PALETTE_MAX_ERR`` levels. The
  PNG frames beside the GIF stay the exact output; the GIF is a preview;
- the pixels: LZW with variable code width, 8-bit root codes and a clear
  code when the table reaches 4096 entries.
"""

from __future__ import annotations

import struct
import warnings
from typing import Sequence

import numpy as np

_LEVELS = (6, 7, 6)        # levels of R, G, B in the fixed colour cube
# the largest distance from a byte to its channel's nearest level: 255/5/2
# and 255/6/2 rounded down to the levels' integer values
PALETTE_MAX_ERR = 25


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


def palette() -> np.ndarray:
    """(256, 3) uint8 colour table: the 252 colours of the cube, index
    ``(r * 7 + g) * 6 + b`` over the channels' level indices, then black."""
    levels = [(np.arange(n) * 255 + (n - 1) // 2) // (n - 1) for n in _LEVELS]
    r, g, b = np.meshgrid(*levels, indexing="ij")
    table = np.zeros((256, 3), np.uint8)
    table[:r.size] = np.stack([r, g, b], -1).reshape(-1, 3)
    return table


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 indices into ``palette()``."""
    f = frame.astype(np.int32)
    idx = [(f[..., i] * (n - 1) + 127) // 255 for i, n in enumerate(_LEVELS)]
    return ((idx[0] * _LEVELS[1] + idx[1]) * _LEVELS[2]
            + idx[2]).astype(np.uint8)


def lzw_codes(pixels: bytes):
    """GIF LZW of 8-bit indices -> (codes, widths) int arrays."""
    clear, eoi = 256, 257
    codes, widths = [clear], [9]
    table: dict = {}
    next_code, width = eoi + 1, 9
    prefix = pixels[0]
    for px in pixels[1:]:
        key = (prefix << 8) | px
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # the decoder adds its entry one code later: widen once the
            # code it will add next no longer fits
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = eoi + 1, 9
        prefix = px
    codes += [prefix, eoi]
    widths += [width, width]
    return np.asarray(codes, np.int64), np.asarray(widths, np.int64)


def pack_codes(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Codes of the given widths, least significant bit first."""
    bit = np.arange(12)
    bits = (codes[:, None] >> bit) & 1
    return np.packbits(bits[bit < widths[:, None]].astype(np.uint8),
                       bitorder="little").tobytes()


def gif_bytes(frames: Sequence[np.ndarray], fps: int = 30) -> bytes:
    """Frames (H, W, 3) uint8 of one size -> an animated GIF89a that
    loops forever."""
    h, w = frames[0].shape[:2]
    table = palette().tobytes()
    delay = int(round(100 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
           + b"\x00"]
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"frames must be ({h}, {w}, 3) uint8, got "
                             f"{f.dtype} {f.shape}")
        data = pack_codes(*lzw_codes(quantize(f).tobytes()))
        blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                          for i in range(0, len(data), 255))
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87), table,
                b"\x08", blocks, b"\x00"]
    out.append(b"\x3b")
    return b"".join(out)


def write_video(path_base: str, frames, fmt: str = "gif",
                fps: int = 30) -> str:
    """Write ``frames`` (list of (H, W, 3) uint8) as ``path_base.gif``.
    ``fmt="mp4"``: no mp4 encoder is available without a codec package, so
    the GIF is written with a warning, as the JAX package does where
    imageio has no mp4 backend. Returns the path written."""
    if fmt not in ("gif", "mp4"):
        raise ValueError(f"video_format must be gif|mp4, got {fmt!r}")
    path = f"{path_base}.gif"
    if fmt == "mp4":
        warnings.warn(
            "mp4 backend unavailable (no mp4 encoder without a codec "
            f"package); wrote {path} instead. Install imageio[ffmpeg] "
            "for mp4 output.", stacklevel=2)
    data = gif_bytes(list(frames), fps)
    with open(path, "wb") as f:
        f.write(data)
    return path
