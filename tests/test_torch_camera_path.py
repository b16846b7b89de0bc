"""The port's camera paths (``crnerf_tpu_torch/render/camera_path.py``)
against crnerf_tpu's: the presets, the demo anchors, the float64 poses bit
for bit, the scene resolution and its KeyError, the intrinsics, and the
host rays of a path within 1e-6."""

import dataclasses

import numpy as np
import pytest

from crnerf_tpu.render import camera_path as jcp
from crnerf_tpu_torch.render import camera_path as cp


def test_presets_and_anchors_are_jax_s():
    assert list(cp.PATH_PRESETS) == list(jcp.PATH_PRESETS)
    for key, spec in cp.PATH_PRESETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jcp.PATH_PRESETS[key]), key
    assert list(cp.DEMO_ANCHORS) == list(jcp.DEMO_ANCHORS)
    for key, a in cp.DEMO_ANCHORS.items():
        assert a.dtype == np.float32
        assert np.array_equal(a, jcp.DEMO_ANCHORS[key]), key


@pytest.mark.parametrize("n", (240, 24, 7))
@pytest.mark.parametrize("key", sorted(jcp.PATH_PRESETS))
def test_poses_are_jax_s_bits(key, n):
    rng = np.random.default_rng(n)
    anchors = [rng.normal(size=(3, 4)).astype(np.float32)]
    anchors += list(jcp.DEMO_ANCHORS.values())
    spec = dataclasses.replace(cp.PATH_PRESETS[key], n_frames=n)
    jspec = dataclasses.replace(jcp.PATH_PRESETS[key], n_frames=n)
    for anchor in anchors:
        got = spec.poses(anchor)
        assert got.dtype == np.float32 and got.shape == (n, 3, 4)
        assert np.array_equal(got, jspec.poses(anchor))


def test_helpers_are_jax_s():
    for theta in ((0.1, -0.2, 0.3), (np.pi / 6, 0.0, -np.pi / 10)):
        assert np.array_equal(cp.euler_to_rotmat(theta),
                              jcp.euler_to_rotmat(theta))
    segs = [(0.0, 1.0, 0.3), (1.0, -2.0, 0.3), (-2.0, 0.5, 0.4)]
    for n in (1, 10, 241):
        assert np.array_equal(cp.piecewise_linspace(segs, n),
                              jcp.piecewise_linspace(segs, n))
    assert np.array_equal(cp.piecewise_linspace([], 5),
                          jcp.piecewise_linspace([], 5))
    for wh, fov in (((320, 240), 60.0), ((37, 29), 45.0)):
        assert np.array_equal(cp.fov_intrinsics(wh, fov),
                              jcp.fov_intrinsics(wh, fov))


@pytest.mark.parametrize("name", ["brandenburg_gate", "cli_brandenburg_gate",
                                  "0_trevi_fountain_x", "sacre_coeur",
                                  "nowhere"])
def test_resolve_scene_is_jax_s(name):
    try:
        want = jcp.resolve_scene(name)
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            cp.resolve_scene(name)
        assert str(got.value) == str(e)
        assert "no camera-path preset" in str(got.value)
        return
    assert cp.resolve_scene(name) == want


def test_path_rays_within_1e6_of_jax_s():
    spec = dataclasses.replace(cp.PATH_PRESETS["trevi_fountain"], n_frames=5)
    jspec = dataclasses.replace(jcp.PATH_PRESETS["trevi_fountain"],
                                n_frames=5)
    anchor = cp.DEMO_ANCHORS["trevi_fountain"]
    got = list(cp.test_path_rays(spec, anchor, (37, 29), 0.0, 5.0))
    want = list(jcp.test_path_rays(jspec, anchor, (37, 29), 0.0, 5.0))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape == (37 * 29, 8) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
