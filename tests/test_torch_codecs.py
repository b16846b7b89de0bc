"""The port's standard-library image codecs against PIL, with PIL, imageio
and cv2 blocked while the port's code runs: ``utils/png.py`` ``read_png``
(every colour type, every row filter, odd widths; the refusals),
``utils/lanczos.py`` ``resize_lanczos`` (PIL's LANCZOS bytes) and
``utils/visualization.py`` ``write_video`` (a GIF that PIL decodes, within
the palette's stated bound; the mp4 warning as the JAX package gives it)."""

import io
import re
import struct
import sys
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from crnerf_tpu_torch.tools.codec_times import filtered_png_bytes, frame_rgba
from crnerf_tpu_torch.utils import visualization
from crnerf_tpu_torch.utils.lanczos import resize_lanczos
from crnerf_tpu_torch.utils.png import read_png

CODEC_MODULES = ("PIL", "PIL.Image", "imageio", "imageio.v2", "cv2")


@pytest.fixture
def no_codecs(monkeypatch):
    """Importing PIL, imageio or cv2 fails while the test runs (the card
    machine has none of them)."""
    for name in CODEC_MODULES:
        monkeypatch.setitem(sys.modules, name, None)


def filter_fixture(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """(h, w, c) uint8 whose row bands make PIL's encoder (with
    ``optimize=True``, which also tries Average) pick each filter: an
    alternating pattern (None), a ramp (Sub), the row above plus noise
    (Up), rows averaging their left and upper neighbours after a random
    row (Average), and steps plus a slow row offset (Paeth)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, c), np.int64)
    xs, chan = np.arange(w)[:, None], np.arange(c)[None, :]
    steps = (xs // 6 * 97) % 256
    for y in range(h):
        k = y % 9
        if k == 0:
            row = ((xs + y) % 2) * 5 + 0 * chan
        elif k == 1:
            row = 7 * xs + rng.integers(256) + 3 * chan
        elif k == 2:
            row = img[y - 1] + rng.integers(0, 2, (w, c))
        elif k == 3:
            row = rng.integers(0, 256, (w, c))
        elif k in (4, 5):
            row = np.zeros((w, c), np.int64)
            noise = rng.integers(0, 2, (w, c))
            for x in range(w):
                row[x] = ((((row[x - 1] if x else 0) + img[y - 1, x]) >> 1)
                          + noise[x])
        else:
            row = steps + 2 * y + 11 * chan
        img[y] = row % 256
    return img.astype(np.uint8)


def png_filters(data: bytes) -> set:
    """The filter types of a PNG's rows."""
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            h = struct.unpack(">I", body[4:8])[0]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


H, W = 53, 37     # odd sizes


def _save(img: Image.Image, path, **kw) -> bytes:
    img.save(path, "PNG", **kw)
    return path.read_bytes()


def write_fixture(kind: str, path) -> bytes:
    """A PIL-written PNG of one colour type (and tRNS form)."""
    if kind in ("L", "LA", "RGB", "RGBA"):
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[kind]
        a = filter_fixture(H, W, c, c)
        return _save(Image.fromarray(a[..., 0] if c == 1 else a, kind),
                     path, optimize=True)
    rgb = filter_fixture(H, W, 3, 5)
    if kind == "L-key":     # grey with a tRNS colour key
        a = rgb[..., 0].copy()
        a[3, 4] = 77
        return _save(Image.fromarray(a, "L"), path, transparency=77)
    if kind == "RGB-key":
        rgb[3, 4] = (10, 20, 30)
        return _save(Image.fromarray(rgb), path, transparency=(10, 20, 30))
    pal = Image.fromarray(rgb).quantize(50)
    if kind == "P":
        return _save(pal, path)
    if kind == "P-trns1":   # one fully transparent palette entry
        return _save(pal, path, transparency=3)
    # an alpha for each palette entry
    return _save(Image.fromarray(filter_fixture(H, W, 4, 6), "RGBA")
                 .quantize(60), path)


KINDS = ("L", "LA", "RGB", "RGBA", "P", "P-trns1", "P-alphas", "L-key",
         "RGB-key")


@pytest.mark.parametrize("mode", ("RGB", "RGBA"))
@pytest.mark.parametrize("kind", KINDS)
def test_read_png_gives_pil_s_bytes(tmp_path, monkeypatch, kind, mode):
    path = tmp_path / f"{kind}.png"
    write_fixture(kind, path)
    with warnings.catch_warnings():   # PIL on a palette with alphas
        warnings.simplefilter("ignore", UserWarning)
        want = np.asarray(Image.open(path).convert(mode))
    for name in CODEC_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    got = read_png(str(path), mode)
    assert got.dtype == np.uint8 and got.shape == (H, W, len(mode))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ("L", "LA", "RGB", "RGBA"))
def test_fixture_rows_use_every_filter(tmp_path, kind):
    assert png_filters(write_fixture(kind, tmp_path / "a.png")) == {
        0, 1, 2, 3, 4}


def test_read_png_of_a_blender_frame(tmp_path, no_codecs):
    """An 800 x 800 RGBA frame written with every filter, row by row."""
    img = frame_rgba(800, 800, 3)
    data = filtered_png_bytes(img, np.arange(800) % 5)
    assert png_filters(data) == {0, 1, 2, 3, 4}
    path = tmp_path / "f.png"
    path.write_bytes(data)
    assert np.array_equal(read_png(str(path), "RGBA"), img)
    assert np.array_equal(read_png(str(path), "RGB"), img[..., :3])


def test_filtered_writer_is_read_by_pil():
    img = frame_rgba(H, W, 1)
    for c, mode in ((1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA")):
        data = filtered_png_bytes(img[..., :c].copy(), np.arange(H) % 5)
        got = np.asarray(Image.open(io.BytesIO(data)))
        assert np.array_equal(got, img[..., 0] if c == 1 else img[..., :c])


def _refusal(kind: str, path) -> str:
    if kind == "16-bit":
        Image.fromarray(np.arange(H * W, dtype=np.uint16).reshape(H, W)
                        * 20).save(path)
        return "bit depth 16"
    data = bytearray(write_fixture("RGB", path))
    if kind == "interlaced":   # the IHDR's last byte; its CRC made anew
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29]))
                                  & 0xFFFFFFFF)
        path.write_bytes(bytes(data))
        return "interlaced"
    data[data.index(b"IDAT") + 4] ^= 0xFF   # the first IDAT's first byte
    path.write_bytes(bytes(data))
    return "fails its CRC"


@pytest.mark.parametrize("kind", ("16-bit", "interlaced", "bad CRC"))
def test_read_png_refuses(tmp_path, kind):
    path = tmp_path / "x.png"
    what = _refusal(kind, path)
    with pytest.raises(ValueError, match=re.escape(what)) as e:
        read_png(str(path))
    assert str(path) in str(e.value)


# (input (h, w), output (w, h)): a Blender frame to a small image and to the
# appearance image, an upsample at odd sizes, and 1:1
RESIZES = (((800, 800), (64, 64)), ((800, 800), (224, 160)),
           ((29, 37), (64, 48)), ((29, 37), (37, 29)))


@pytest.mark.parametrize("hw,out_wh", RESIZES)
def test_resize_lanczos_gives_pil_s_bytes(hw, out_wh, monkeypatch):
    """Bound: one level (1/255); measured 0 pixels off at every size."""
    img = frame_rgba(*hw, 4)[..., :3].copy()
    want = np.asarray(Image.fromarray(img).resize(out_wh, Image.LANCZOS))
    for name in CODEC_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    got = resize_lanczos(img, out_wh)
    assert got.shape == want.shape == (out_wh[1], out_wh[0], 3)
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1, f"{int((diff > 0).sum())} values differ"
    print(f"{hw} -> {out_wh}: {int((diff > 0).sum())} values differ")


def test_palette_bound():
    """Every byte of every channel lands within PALETTE_MAX_ERR of its
    colour in the table (the channels are quantised apart, so one sweep of
    each channel covers every colour)."""
    v = np.arange(256, dtype=np.uint8)
    sweep = np.stack([v, v, v], -1)[None]
    got = visualization.palette()[visualization.quantize(sweep)]
    err = np.abs(got.astype(int) - sweep).max(axis=(0, 1))
    assert err.max() == visualization.PALETTE_MAX_ERR
    assert tuple(err) == (25, 21, 25)


def test_gif_is_read_by_pil(tmp_path, monkeypatch):
    """Frames of ramps and of noise (the noise fills the LZW table: clear
    codes at 4096) at 10 fps: the frame count, size, delay and loop, each
    frame the palette colours of its pixels."""
    rng = np.random.default_rng(0)
    frames = [frame_rgba(90, 121, i)[..., :3].copy() for i in range(3)]
    frames.append(rng.integers(0, 256, (90, 121, 3), dtype=np.uint8))
    with monkeypatch.context() as m:
        for name in CODEC_MODULES:
            m.setitem(sys.modules, name, None)
        path = visualization.write_video(str(tmp_path / "v"), frames, fps=10)
    assert path == str(tmp_path / "v.gif")
    codes, _ = visualization.lzw_codes(
        visualization.quantize(frames[-1]).tobytes())
    assert (codes == 256).sum() > 1
    from PIL import ImageSequence

    im = Image.open(path)
    assert im.size == (121, 90) and im.n_frames == 4
    assert im.info["loop"] == 0
    table = visualization.palette()
    for f, fr in zip(frames, ImageSequence.Iterator(im)):
        assert fr.info["duration"] == 100
        got = np.asarray(fr.convert("RGB"))
        assert np.array_equal(got, table[visualization.quantize(f)])
        assert np.abs(got.astype(int) - f).max() <= (
            visualization.PALETTE_MAX_ERR)


def test_mp4_writes_the_gif_with_jax_s_warning(tmp_path):
    """No mp4 encoder here, nor on the card machine: both packages write
    the GIF and warn in the same words."""
    from crnerf_tpu.utils.visualization import write_video as jax_write

    frames = [frame_rgba(8, 12, i)[..., :3].copy() for i in range(2)]
    pat = (r"^mp4 backend unavailable \(.*\); wrote (\S+\.gif) instead\. "
           r"Install imageio\[ffmpeg\] for mp4 output\.$")
    for who, fn in (("port", visualization.write_video),
                    ("jax", jax_write)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            path = fn(str(tmp_path / who), frames, fmt="mp4")
        msgs = [str(x.message) for x in w
                if str(x.message).startswith("mp4 backend")]
        assert len(msgs) == 1, (who, [str(x.message) for x in w])
        m = re.match(pat, msgs[0], re.S)
        assert m and m.group(1) == path == str(tmp_path / f"{who}.gif")
        assert Image.open(path).n_frames == 2
