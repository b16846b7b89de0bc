"""The port's Blender loader (``crnerf_tpu_torch/data/blender.py``) against
crnerf_tpu's: the perturbations bit for bit, and a scene of 800 x 800 RGBA
frames with ``color`` + ``occ`` loaded by both, the port with PIL, imageio
and cv2 blocked: the cameras, bounds, names and flags equal, the rgbs
within 1/255 and the appearance images ([-1, 1]) within 2/255."""

import json
import sys

import numpy as np
import pytest
from PIL import Image

from crnerf_tpu.data import blender as jblender
from crnerf_tpu_torch.data import blender
from crnerf_tpu_torch.tools.codec_times import frame_rgba

CODEC_MODULES = ("PIL", "PIL.Image", "imageio", "imageio.v2", "cv2")


@pytest.mark.parametrize("seed", (1, 2, 7))
@pytest.mark.parametrize("perturbation", (("occ",), ("color",),
                                          ("color", "occ")))
def test_add_perturbation_is_jax_s_bits(perturbation, seed):
    img = np.random.default_rng(seed).uniform(0, 1, (800, 800, 3)).astype(
        np.float32)
    got = blender.add_perturbation(img, perturbation, seed)
    want = jblender.add_perturbation(img, perturbation, seed)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def write_scene(root, n_train: int = 3, n_test: int = 2, wh=(800, 800)):
    """A Blender-layout scene of seeded RGBA frames (an opaque disc on a
    transparent background), PNGs written by PIL."""
    for split, n in (("train", n_train), ("test", n_test)):
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for t in range(n):
            name = f"{split}/r_{t}"
            Image.fromarray(frame_rgba(wh[1], wh[0], 10 * n_train + t),
                            "RGBA").save(root / f"{name}.png")
            pose = np.eye(4)
            pose[:3, 3] = (0.3 * t, -0.1 * t, 4.0)
            frames.append({"file_path": name,
                           "transform_matrix": pose.tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.6911, "frames": frames}))


@pytest.mark.parametrize("split", ("train", "test_test"))
def test_load_blender_matches_jax(tmp_path, monkeypatch, split):
    root = tmp_path / "lego"
    write_scene(root)
    kw = dict(split=split, img_wh=(400, 400), perturbation=("color", "occ"),
              appearance_wh=(224, 160))
    want = jblender.load_blender(str(root), **kw)
    for name in CODEC_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    got = blender.load_blender(str(root), **kw)
    assert (got.name, got.white_back, got.appearance_wh) == (
        want.name, want.white_back, want.appearance_wh) == (
        "lego", True, (224, 160))
    assert len(got.images) == len(want.images) == (3 if split == "train"
                                                   else 2)
    for g, w in zip(got.images, want.images):
        assert (g.id, g.name, g.wh, g.near, g.far, g.split) == (
            w.id, w.name, w.wh, w.near, w.far, w.split)
        assert np.array_equal(g.K, w.K) and np.array_equal(g.c2w, w.c2w)
        assert g.rgbs.shape == w.rgbs.shape == (400 * 400, 3)
        assert g.appearance.shape == w.appearance.shape == (160, 224, 3)
        assert np.abs(g.rgbs - w.rgbs).max() <= 1 / 255 + 1e-7
        assert np.abs(g.appearance - w.appearance).max() <= 2 / 255 + 1e-7
    if split == "train":   # frame 0 is never perturbed, the others are
        clean = blender.load_blender(str(root), **dict(kw, perturbation=()))
        assert np.array_equal(clean.images[0].rgbs, got.images[0].rgbs)
        assert not np.array_equal(clean.images[1].rgbs, got.images[1].rgbs)


def test_load_blender_refuses_other_perturbations(tmp_path):
    with pytest.raises(ValueError, match="subset of color, occ"):
        blender.load_blender(str(tmp_path), perturbation=("blur",))
