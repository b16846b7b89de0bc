"""PNG without an image library, on the standard library (zlib + struct)
and numpy: an 8-bit RGB writer, shared by the server, the eval apps and
the metric logger, and a reader for the 8-bit files the apps and the
Blender loader take in (``read_png``: what
``np.asarray(PIL.Image.open(path).convert(mode))`` gives, byte for byte).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (0 grey, 2 RGB, 3 palette, 4 grey + alpha,
# 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """``png_bytes`` to a file, written tmp + rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png_bytes(rgb))
    os.replace(tmp, path)


def _chunks(data: bytes, path: str):
    """(tag, body) of every chunk, each CRC checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: chunk {tag!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters. raw (h, w * bpp) uint8 filtered bytes,
    filters (h,) in 0..4 (None, Sub, Up, Average, Paeth) -> (h, w * bpp)
    uint8.

    A byte depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal (x + y constant) depend only on earlier
    diagonals: each diagonal is one vector step over the rows it crosses,
    each row applying its own filter. The diagonals live in a skewed array
    ``t[d + 2, y + 1] = pixel (y, x = d - y)`` whose zero border is PNG's
    zero outside the image."""
    h = raw.shape[0]
    w = raw.shape[1] // bpp
    n_diag = h + w - 1
    yy, xx = np.divmod(np.arange(h * w), w)
    r = np.zeros((n_diag, h, bpp), np.int16)
    r[yy + xx, yy] = raw.reshape(h * w, bpp)
    t = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    f = filters.astype(np.intp)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = t[d + 1, y0 + 1:y1 + 1]       # left
        b = t[d + 1, y0:y1]               # up
        c = t[d, y0:y1]                   # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(f[y0:y1], (zero[:y1 - y0], a, b, (a + b) >> 1,
                                    paeth))
        t[d + 2, y0 + 1:y1 + 1] = (r[d, y0:y1] + pred) & 255
    return t[yy + xx + 2, yy + 1].astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """An 8-bit, non-interlaced PNG as (H, W, 3) (``mode="RGB"``) or
    (H, W, 4) (``"RGBA"``) uint8: ``np.asarray(PIL.Image.open(path)
    .convert(mode))`` byte for byte. Grey, RGB, palette (with ``tRNS``),
    grey + alpha and RGBA files; grey and RGB files with a ``tRNS`` colour
    key take alpha 0 on that colour. Raises ``ValueError`` for other bit
    depths, for interlaced files and for a chunk whose CRC fails."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"mode must be RGB or RGBA, got {mode!r}")
    with open(path, "rb") as fh:
        data = fh.read()
    hdr, idat, plte, trns = None, [], None, None
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8-bit PNGs are "
                         "read")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7); only non-interlaced "
                         "PNGs are read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {ctype}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    raw = raw.reshape(h, 1 + w * bpp)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown filter type {raw[:, 0].max()}")
    px = unfilter(raw[:, 1:], raw[:, 0], bpp).reshape(h, w, bpp)

    alpha = np.full((h, w, 1), 255, np.uint8)
    if ctype == 3:
        lut = np.full((256, 4), 255, np.uint8)
        lut[:len(plte), :3] = plte
        if trns is not None:
            lut[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        out = lut[px[..., 0]]
        return out[..., :3] if mode == "RGB" else out
    if ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, -1)
        if ctype == 4:
            alpha = px[..., 1:]
    else:
        rgb = px[..., :3]
        if ctype == 6:
            alpha = px[..., 3:]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if trns is not None and ctype in (0, 2):
        # the colour key, in 16-bit samples
        key = np.frombuffer(trns, ">u2")[:bpp].astype(np.int32)
        hit = (px[..., :bpp].astype(np.int32) == key).all(-1, keepdims=True)
        alpha = np.where(hit, np.uint8(0), alpha)
    return np.concatenate([rgb, alpha], -1)
