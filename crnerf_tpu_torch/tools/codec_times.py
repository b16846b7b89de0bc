"""Host times of the port's standard-library image codecs at the sizes the
apps give them: ``read_png`` of an 800 x 800 RGBA PNG (a Blender frame)
whose rows use every filter type, ``resize_lanczos`` of that frame to 400
x 400 and to the 224 x 160 appearance image, and the GIF of 24 frames of
320 x 240. The codecs run on the host CPU only, wherever the process runs;
the line names its CPU count.

Run:  python -m crnerf_tpu_torch.tools.codec_times [--reps 5]

``filtered_png_bytes`` writes a PNG with the row filters it is given
(``chip_smoke.py`` makes its Blender scene with it).
"""

from __future__ import annotations

import argparse
import os
import struct
import tempfile
import time
import zlib
from typing import Optional, Sequence

import numpy as np

from crnerf_tpu_torch.utils.lanczos import resize_lanczos
from crnerf_tpu_torch.utils.png import read_png
from crnerf_tpu_torch.utils.visualization import gif_bytes

# channels -> PNG colour type (grey, grey + alpha, RGB, RGBA)
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def filtered_png_bytes(img: np.ndarray, filters: Sequence[int]) -> bytes:
    """(H, W, C) uint8, C in 1..4 -> 8-bit PNG bytes whose row y is filtered
    with ``filters[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    px = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(px)
    a[:, c:] = px[:, :-c]                 # left
    b = np.zeros_like(px)
    b[1:] = px[:-1]                       # up
    cc = np.zeros_like(px)
    cc[1:, c:] = px[:-1, :-c]             # up-left
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = np.stack([np.zeros_like(px), a, b, (a + b) >> 1, paeth])
    f = np.asarray(filters, np.intp)
    res = ((px - preds[f, np.arange(h)]) & 255).astype(np.uint8)
    rows = np.concatenate([f.astype(np.uint8)[:, None], res], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOR_TYPE[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def frame_rgba(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded RGBA test frame: smooth colour ramps, noise, an alpha disc
    on a transparent background (a Blender object on white)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin((x + y) / 37.0)], -1)
    rgb = rgb * 200 + rng.integers(0, 56, (h, w, 3))
    r = np.hypot(x - w / 2, y - h / 2)
    alpha = np.clip((0.4 * min(h, w) - r) * 8, 0, 255)
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    img = frame_rgba(800, 800, 0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.png")
        with open(path, "wb") as f:
            f.write(filtered_png_bytes(img, np.arange(800) % 5))
        decode = median_s(lambda: read_png(path, "RGBA"), args.reps)
        if not np.array_equal(read_png(path, "RGBA"), img):
            raise SystemExit("read_png does not give the written image")
    rgb = img[..., :3].copy()
    half = median_s(lambda: resize_lanczos(rgb, (400, 400)), args.reps)
    app = median_s(lambda: resize_lanczos(rgb, (224, 160)), args.reps)
    frames = [frame_rgba(240, 320, i)[..., :3].copy() for i in range(24)]
    gif = median_s(lambda: gif_bytes(frames), max(1, args.reps // 2))
    print(f"host ({os.cpu_count()} CPUs): read_png 800x800 RGBA, filters "
          f"0-4: {decode:.4f} s; resize_lanczos 800x800 -> 400x400 "
          f"{half:.4f} s, -> 224x160 {app:.4f} s; GIF of 24 frames of "
          f"320x240 {gif:.4f} s (medians of {args.reps})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
