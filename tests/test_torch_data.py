"""The port's host-side data layer (crnerf_tpu_torch.data, numpy) against
the JAX package's: the synthetic scene, its flat ray buffers, the grid
sampler and TrainPipeline.make_global_batch, array for array. Both are
numpy running the same arithmetic, so equality is exact."""

import numpy as np
import pytest

from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.sampler import GridSampler as JaxSampler
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu_torch.data.pipeline import TrainPipeline
from crnerf_tpu_torch.data.sampler import GridSampler
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene

SCENE_KW = dict(n_train=4, n_test=1, img_wh=(28, 21), appearance_wh=(64, 48))


@pytest.fixture(scope="module")
def scenes():
    return make_synthetic_scene(**SCENE_KW), jax_scene(**SCENE_KW)


@pytest.mark.parametrize("occluders", [False, True])
def test_synthetic_scene_equal(occluders):
    a = make_synthetic_scene(occluders=occluders, seed=3, **SCENE_KW)
    b = jax_scene(occluders=occluders, seed=3, **SCENE_KW)
    assert len(a.images) == len(b.images) == 5
    assert a.appearance_wh == b.appearance_wh
    for ia, ib in zip(a.images, b.images):
        assert (ia.id, ia.name, ia.wh, ia.split, ia.near, ia.far) == (
            ib.id, ib.name, ib.wh, ib.split, ib.near, ib.far)
        for f in ("K", "c2w", "rgbs", "appearance"):
            x, y = getattr(ia, f), getattr(ib, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [im.split for im in a.images].count("train") == 4


def test_ray_buffers_equal(scenes):
    a, b = (s.build_ray_buffers() for s in scenes)
    for f in ("all_rays", "all_rgbs", "offsets", "appearance_stack"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.all_rays.shape == (4 * 28 * 21, 9)
    assert a.n_rays() == b.n_rays()
    np.testing.assert_array_equal(a.image_rays(a.test_images[0]),
                                  b.image_rays(b.test_images[0]))


@pytest.mark.parametrize("scale_anneal", [-1.0, 0.01])
def test_grid_sampler_equal(scenes, scale_anneal):
    a = scenes[0].build_ray_buffers()
    whs = np.asarray([im.wh for im in a.train_images], np.int64)
    kw = dict(n_images=4, image_whs=whs, offsets=a.offsets, batch_size=49,
              scale_anneal=scale_anneal, seed_salt=5)
    sa, sb = GridSampler(**kw), JaxSampler(**kw)
    assert sa.iterations == sb.iterations == (4 * 28 * 21) // 49
    for epoch, idx in ((0, 0), (0, 7), (3, 2)):
        x, y = sa.sample(epoch, idx), sb.sample(epoch, idx)
        assert set(x) == set(y)
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


@pytest.mark.parametrize("n_grids", [1, 2, 16])
def test_make_global_batch_equal(scenes, n_grids):
    pa = TrainPipeline(scenes[0], batch_size=64)
    pb = JaxPipeline(scenes[1], batch_size=64)
    assert pa.iterations == pb.iterations
    for i in range(2):
        x = pa.make_global_batch(0, i, n_grids)
        y = pb.make_global_batch(0, i, n_grids)
        assert set(x) == set(y) == {"rays", "ts", "rgbs", "whole_img",
                                    "uv_pix", "image_idx"}
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert np.array_equal(x[k], y[k]), k
        assert x["rays"].shape == (n_grids, 64, 8)
        assert x["whole_img"].shape == (n_grids, 1, 48, 64, 3)


def test_make_batch_is_a_pure_function_of_epoch_and_index(scenes):
    p = TrainPipeline(scenes[0], batch_size=64)
    a, b = p.make_batch(1, 3), p.make_batch(1, 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["rays"], p.make_batch(1, 4)["rays"])
    g = p.make_global_batch(0, 2, 3)
    assert np.array_equal(g["rays"][1], p.make_batch(0, 2 * 3 + 1)["rays"])
