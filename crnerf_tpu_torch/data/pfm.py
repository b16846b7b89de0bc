"""PFM depth-map I/O (``crnerf_tpu/data/pfm.py``; numpy only). Not on the
training path; part of the data layer's surface.

Format: 'PF' (color) / 'Pf' (gray) header, dims line, scale line whose sign
encodes endianness, then raw float32 rows bottom-to-top.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """-> (data (H, W[, 3]) float32, scale float)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"malformed PFM header: {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.frombuffer(f.read(), endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)).copy(), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)
