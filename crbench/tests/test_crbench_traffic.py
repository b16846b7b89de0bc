"""The traffic and the inputs are the same for one seed and differ across
seeds, with the same sizes for every seed."""

import numpy as np
import pytest
import torch

from crbench import camera, scene
from crbench.harness import Run, load_json, percentile
from crbench.traffic import serve_closed
from crbench.weights import seeded_entries

SEEDS = (7, 2 ** 31 + 11)


def run_of(seed, cell="serve_320x240_c4"):
    wl = load_json("workloads", cell + ".json")
    cfg = load_json("configs", wl["config"] + ".json")
    return Run(cell, wl, cfg, seed, 30.0, False, torch.device("cpu"), 0.0,
               "/nonexistent")


def test_serve_plan_repeats_for_a_seed_and_moves_across_seeds():
    a, b = (serve_closed.plan_of(run_of(s), 1, "x") for s in SEEDS)
    assert serve_closed.plan_of(run_of(SEEDS[0]), 1, "x") == a
    assert (a["offset"], a["styles"], a["sample_seed"]) != (
        b["offset"], b["styles"], b["sample_seed"])
    assert sorted(a["styles"]) == sorted(b["styles"])
    assert a["poses"] == b["poses"] and len(a["poses"]) == 240
    assert (a["clients"], a["wh"]) == (b["clients"], b["wh"])


def test_style_images_repeat_and_move():
    a, b = (serve_closed.style_images(s, 8, (224, 160)) for s in SEEDS)
    again = serve_closed.style_images(SEEDS[0], 8, (224, 160))
    assert all(np.array_equal(x, y) for x, y in zip(a, again))
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))
    assert {x.shape for x in a + b} == {(160, 224, 3)}


def test_scene_repeats_and_moves():
    a, b = (scene.make_images(3, (48, 36), (64, 48), s) for s in SEEDS)
    again = scene.make_images(3, (48, 36), (64, 48), SEEDS[0])
    assert all(np.array_equal(x.rgbs, y.rgbs) for x, y in zip(a, again))
    assert not np.array_equal(a[0].rgbs, b[0].rgbs)
    assert all(np.array_equal(x.c2w, y.c2w) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_repeat_for_a_seed(seed):
    shapes = {"a.weight": (4, 3), "a.bias": (4,),
              "n._Norm_0.BatchNorm_0.running_var": (4,)}
    x, y = (seeded_entries(shapes, seed, "cpu") for _ in range(2))
    assert all(torch.equal(x[k], y[k]) for k in shapes)
    assert float(x["n._Norm_0.BatchNorm_0.running_var"].min()) >= 0.5
    assert float(x["a.weight"].abs().max()) <= (6 / 3) ** 0.5


def test_path_and_frame_rays():
    poses = camera.path_poses(240)
    assert poses.shape == (240, 3, 4) and poses.dtype == np.float32
    rays, uv = camera.frame_rays(poses[0], camera.fov_k((32, 24)), 0.0, 5.0,
                                 (24, 32), "cpu")
    assert rays.shape == (768, 8) and uv.shape == (768, 2)
    assert torch.allclose(rays[:, 3:6].norm(dim=-1), torch.ones(768))


def test_percentile_is_nearest_rank():
    v = list(range(1, 201))
    assert percentile(v, 95) == 190
    assert percentile([float("inf")] + v[:19], 95) == 19
