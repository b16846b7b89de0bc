"""8-bit RGB PNG encode and decode with the standard library and numpy:
the seeded style images the serving cells register, and the frames their
replies carry. Decoding handles all five row filters."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """(h, w, 3) uint8 -> PNG bytes (filter 0 on every row)."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img, np.uint8).reshape(h, -1)],
                         1)
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                               0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, not interlaced) -> (h, w, 3) uint8."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, [], 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, lace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, lace) != (8, 2, 0):
                raise ValueError(f"PNG depth/type/interlace {depth}/{ctype}/"
                                 f"{lace}")
        elif tag == b"IDAT":
            idat.append(body)
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        f, r = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = r
        elif f == 2:
            cur = (r + prev) & 255
        else:   # sub, average, paeth: left to right, a pixel at a time
            cur = np.zeros_like(r)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if f == 1:
                    p = a
                elif f == 3:
                    p = (a + b) // 2
                elif f == 4:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                         else c)
                else:
                    raise ValueError(f"PNG row filter {f}")
                cur[x] = (r[x] + p) & 255
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, 3)
