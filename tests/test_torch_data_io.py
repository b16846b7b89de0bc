"""The port's data layer against crnerf_tpu's: COLMAP readers (binary
files written by the JAX writers, read by both packages bit for bit; the
text readers on a hand-written model), PFM, the phototourism cache in both
directions (every array bit-equal), the raw phototourism loader on an
on-disk fixture, the prefetched epoch batches (mid-epoch start, early
break) and the full-image batch."""

import dataclasses
import os
import threading

import numpy as np
import pytest

from crnerf_tpu.data import colmap as jcolmap
from crnerf_tpu.data import pfm as jpfm
from crnerf_tpu.data import phototourism as jphoto
from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.pipeline import full_image_batch as jax_full_image
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu_torch.data import colmap, pfm, phototourism
from crnerf_tpu_torch.data.pipeline import TrainPipeline, full_image_batch
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene


def _write_model(d):
    """A small COLMAP model through the JAX package's binary writers."""
    rng = np.random.RandomState(0)
    cams = {1: jcolmap.Camera(1, "PINHOLE", 64, 48,
                              np.array([60.0, 61.0, 32.0, 24.0])),
            2: jcolmap.Camera(2, "SIMPLE_RADIAL", 80, 60,
                              np.array([70.0, 40.0, 30.0, 0.01]))}
    ims = {}
    for i in (3, 7):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        ims[i] = jcolmap.Image(i, q, rng.randn(3), 1 + i % 2,
                               f"img_{i:03d}.jpg", rng.randn(5, 2),
                               rng.randint(-1, 30, 5).astype(np.int64))
    pts = {pid: jcolmap.Point3D(pid, rng.randn(3),
                                rng.randint(0, 255, 3), rng.rand(),
                                rng.randint(1, 9, 2).astype(np.int64),
                                rng.randint(0, 5, 2).astype(np.int64))
           for pid in (0, 11, 29)}
    jcolmap.write_cameras_binary(cams, os.path.join(d, "cameras.bin"))
    jcolmap.write_images_binary(ims, os.path.join(d, "images.bin"))
    jcolmap.write_points3d_binary(pts, os.path.join(d, "points3D.bin"))


def _same(a, b):
    """Namedtuple records field by field, arrays bit for bit."""
    assert a.keys() == b.keys()
    for k in a:
        assert type(a[k]).__name__ == type(b[k]).__name__
        for fa, fb in zip(a[k], b[k]):
            if isinstance(fa, np.ndarray):
                assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
            else:
                assert fa == fb


@pytest.mark.parametrize("kind", ["cameras", "images", "points3d"])
def test_colmap_binary_readers_match(tmp_path, kind):
    _write_model(str(tmp_path))
    name = {"cameras": "cameras.bin", "images": "images.bin",
            "points3d": "points3D.bin"}[kind]
    path = str(tmp_path / name)
    fn = f"read_{kind}_binary"
    _same(getattr(colmap, fn)(path), getattr(jcolmap, fn)(path))


def test_colmap_binary_writers_match(tmp_path):
    """The port's writers give the JAX writers' bytes."""
    _write_model(str(tmp_path))
    out = tmp_path / "port"
    out.mkdir()
    colmap.write_cameras_binary(
        colmap.read_cameras_binary(str(tmp_path / "cameras.bin")),
        str(out / "cameras.bin"))
    colmap.write_images_binary(
        colmap.read_images_binary(str(tmp_path / "images.bin")),
        str(out / "images.bin"))
    colmap.write_points3d_binary(
        colmap.read_points3d_binary(str(tmp_path / "points3D.bin")),
        str(out / "points3D.bin"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (out / name).read_bytes() == (tmp_path / name).read_bytes()


_TEXT = {
    "cameras.txt": "# Camera list\n1 PINHOLE 64 48 60 61 32 24\n"
                   "2 SIMPLE_PINHOLE 80 60 70 40 30\n",
    "images.txt": "# Image list\n"
                  "3 0.9 0.1 0.3 0.2 1.5 -2 0.25 1 a.jpg\n"
                  "10.5 20.25 7 11 12 -1\n"
                  "4 1 0 0 0 0 0 4 2 b.jpg\n"
                  "1.0 2.0 -1\n",
    "points3D.txt": "# 3D points\n7 0.5 -1 2 255 128 0 0.75 3 0 4 1\n"
                    "9 1 2 3 10 20 30 1.5 3 1\n",
}


@pytest.mark.parametrize("kind", ["cameras", "images", "points3d"])
def test_colmap_text_readers_match(tmp_path, kind):
    for name, text in _TEXT.items():
        (tmp_path / name).write_text(text)
    name = {"cameras": "cameras.txt", "images": "images.txt",
            "points3d": "points3D.txt"}[kind]
    fn = f"read_{kind}_text"
    got = getattr(colmap, fn)(str(tmp_path / name))
    _same(got, getattr(jcolmap, fn)(str(tmp_path / name)))
    assert len(got) == 2


def test_qvec_rotmat_match():
    rng = np.random.RandomState(3)
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    R = colmap.qvec2rotmat(q)
    assert np.array_equal(R, jcolmap.qvec2rotmat(q))
    assert np.array_equal(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_pfm_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    pfm.save_pfm(str(tmp_path / "p.pfm"), img, scale=2.0)
    jpfm.save_pfm(str(tmp_path / "j.pfm"), img, scale=2.0)
    assert ((tmp_path / "p.pfm").read_bytes()
            == (tmp_path / "j.pfm").read_bytes())
    got, scale = pfm.read_pfm(str(tmp_path / "j.pfm"))
    want, jscale = jpfm.read_pfm(str(tmp_path / "p.pfm"))
    assert np.array_equal(got, img) and np.array_equal(want, img)
    assert scale == jscale == 2.0


def _scenes_equal(a, b):
    assert a.name == b.name and tuple(a.appearance_wh) == tuple(
        b.appearance_wh)
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v), f.name
            else:
                assert u == v, f.name


def _with_a_pixelless_image(scene):
    """One test image without pixels (has_pixels False in the cache)."""
    im = scene.images[-1]
    scene.images[-1] = dataclasses.replace(im, rgbs=None, appearance=None)
    return scene


def test_cache_written_by_jax_loads_in_the_port(tmp_path):
    scene = _with_a_pixelless_image(jax_scene(n_train=3, n_test=2))
    path = jphoto.save_scene_cache(scene, root_dir=str(tmp_path),
                                   img_downscale=2)
    assert path == phototourism.cache_path(str(tmp_path), 2)
    _scenes_equal(phototourism.load_scene_cache(path), scene)
    # and load_phototourism picks it up
    _scenes_equal(phototourism.load_phototourism(str(tmp_path)), scene)


def test_cache_written_by_the_port_loads_in_jax(tmp_path):
    scene = _with_a_pixelless_image(make_synthetic_scene(n_train=3,
                                                         n_test=2))
    path = phototourism.save_scene_cache(scene, root_dir=str(tmp_path),
                                         img_downscale=4)
    _scenes_equal(jphoto.load_scene_cache(path), scene)
    _scenes_equal(jphoto.load_phototourism(str(tmp_path), img_downscale=4),
                  scene)


def _write_phototourism_fixture(root):
    """A tiny on-disk phototourism scene: COLMAP binaries, tsv, images
    (as tests/test_data.py builds it), with a null-id tsv row."""
    from PIL import Image as PILImage

    os.makedirs(os.path.join(root, "dense/sparse"), exist_ok=True)
    os.makedirs(os.path.join(root, "dense/images"), exist_ok=True)
    w0, h0 = 64, 48
    cams, ims = {}, {}
    rng = np.random.RandomState(0)
    names, splits = [], []
    for i in range(4):
        cam_id = i + 1
        cams[cam_id] = jcolmap.Camera(cam_id, "PINHOLE", w0, h0,
                                      np.array([60.0, 60.0, w0 / 2, h0 / 2]))
        theta = i * 0.5
        q = np.array([np.cos(theta / 2), 0, np.sin(theta / 2), 0])
        name = f"img_{i:03d}.jpg"
        names.append(name)
        splits.append("train" if i < 3 else "test")
        ims[cam_id] = jcolmap.Image(cam_id, q,
                                    np.array([0.0, 0.0, 4.0 + 0.1 * i]),
                                    cam_id, name, np.zeros((0, 2)),
                                    np.zeros(0, np.int64))
        arr = rng.uniform(0, 255, (h0, w0, 3)).astype(np.uint8)
        PILImage.fromarray(arr).save(os.path.join(root, "dense/images",
                                                  name))
    pts = {pid: jcolmap.Point3D(pid, rng.uniform(-1, 1, 3)
                                + np.array([0, 0, 1.0]),
                                np.array([128, 128, 128]), 0.5,
                                np.array([1], np.int64),
                                np.array([0], np.int64))
           for pid in range(30)}
    sparse = os.path.join(root, "dense/sparse")
    jcolmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    jcolmap.write_images_binary(ims, os.path.join(sparse, "images.bin"))
    jcolmap.write_points3d_binary(pts, os.path.join(sparse, "points3D.bin"))
    with open(os.path.join(root, "scene.tsv"), "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i, (n, s) in enumerate(zip(names, splits)):
            f.write(f"{n}\t{i}\t{s}\tscene\n")
        f.write("img_000.jpg\t\ttrain\tscene\n")   # null id: dropped


@pytest.mark.parametrize("load_test_images", [True, False])
def test_load_phototourism_matches_jax(tmp_path, load_test_images):
    root = str(tmp_path / "scene")
    _write_phototourism_fixture(root)
    kw = dict(img_downscale=2, appearance_wh=(32, 24), use_cache=False,
              load_test_images=load_test_images)
    got = phototourism.load_phototourism(root, **kw)
    _scenes_equal(got, jphoto.load_phototourism(root, **kw))
    assert len(got.train_images) == 3 and len(got.test_images) == 1


def test_prepare_writes_the_cache_the_jax_loader_reads(tmp_path):
    from crnerf_tpu_torch.apps import prepare

    root = str(tmp_path / "scene")
    _write_phototourism_fixture(root)
    path = prepare.main(["--root_dir", root, "--img_downscale", "2",
                         "--appearance_wh", "32", "24", "--device", "cpu"])
    assert path == phototourism.cache_path(root, 2)
    want = jphoto.save_scene_cache(
        jphoto.load_phototourism(root, img_downscale=2,
                                 appearance_wh=(32, 24), use_cache=False),
        path=str(tmp_path / "jax.npz"))
    _scenes_equal(jphoto.load_scene_cache(path),
                  jphoto.load_scene_cache(want))


def test_a_missing_decoder_names_the_cache_route(tmp_path, monkeypatch):
    import sys

    root = str(tmp_path / "scene")
    _write_phototourism_fixture(root)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="prepare"):
        phototourism.load_phototourism(root, use_cache=False)


@pytest.fixture(scope="module")
def pipelines():
    js = jax_scene(n_train=4, n_test=1, img_wh=(24, 18))
    ps = make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18))
    return (JaxPipeline(js, batch_size=64), TrainPipeline(ps, batch_size=64),
            js, ps)


def _batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("grids,start", [(1, 0), (2, 0), (2, 5), (3, 7)])
def test_epoch_batches_match_jax(pipelines, grids, start):
    jp, pp, _, _ = pipelines
    got = list(pp.epoch_batches(1, grids, n_steps=9, start_step=start))
    want = list(jp.epoch_batches(1, 1, n_steps=9, grids_per_device=grids,
                                 start_step=start))
    assert len(got) == len(want) == 9 - start
    for a, b in zip(got, want):
        _batches_equal(a, b)


def test_epoch_batches_default_length_and_early_break(pipelines):
    _, pp, _, _ = pipelines
    assert len(list(pp.epoch_batches(0, 2))) == pp.iterations // 2
    before = threading.active_count()
    for _ in range(5):
        it = pp.epoch_batches(0, 2, prefetch=1)
        first = next(it)
        it.close()   # the consumer stops early
    _batches_equal(first, pp.make_global_batch(0, 0, 2))
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=5)
    assert threading.active_count() <= before


def test_full_image_batch_matches_jax(pipelines):
    _, _, js, ps = pipelines
    for ji, pi in zip(js.images, ps.images):
        _batches_equal(full_image_batch(ps, pi), jax_full_image(js, ji))
    style = np.zeros((48, 64, 3), np.float32)
    _batches_equal(full_image_batch(ps, ps.images[0], style),
                   jax_full_image(js, js.images[0], style))


def test_load_scene_from_config():
    from crnerf_tpu_torch import Config
    from crnerf_tpu_torch.apps import load_scene_from_config

    sc = load_scene_from_config(Config(dataset_name="synthetic",
                                       appearance_wh=(64, 48)))
    assert len(sc.train_images) == 6 and sc.appearance_wh == (64, 48)
    # blender reads the transforms of the split it is given
    for split, name in (("train", "transforms_train.json"),
                        ("test_test", "transforms_test.json")):
        with pytest.raises(FileNotFoundError, match=name):
            load_scene_from_config(Config(dataset_name="blender",
                                          root_dir="missing"), split)
    with pytest.raises(ValueError, match="unknown dataset"):
        load_scene_from_config(Config(dataset_name="nope"))
