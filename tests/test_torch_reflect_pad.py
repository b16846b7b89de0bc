"""The port's reflection padding (``models/common.py`` ``reflect_pad``)
against ``crnerf_tpu/models/common.py`` ``reflect_pad`` (``jnp.pad``,
numpy's reflect mode) at every size and pad: a size-1 axis repeats its one
entry, and a pad of at least the size reflects again. The appearance
encoder therefore takes the 4 x 4 grids of ``--batch_size 16``, whose
random-style re-encode reaches its last padded convolution as a 1 x 1
map, and the Blender CLI trains at that batch size, as the JAX package
does (tests/test_apps.py). Where the pad is below the size the forward is
``F.pad(mode="reflect")``'s bits and the backward the fixed-order fold the
port had before, bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from crnerf_tpu.models import AppearanceEncoder as FlaxAppearanceEncoder
from crnerf_tpu.models import common as jcommon
from crnerf_tpu_torch.models import common as tcommon
from crnerf_tpu_torch.models.appearance import AppearanceEncoder
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_reflect_pad_matches_jnp_pad_forward_and_vjp(size, pad):
    """Forward: the same values exactly. Backward (each padded entry added
    onto the entry it copies; up to (2 pad + 1)^2 terms an entry at size
    1): within 8 fp32 ulps of the largest gradient entry, the difference
    of two summation orders."""
    x = _np((2, size, size + 1, 3), 10 * size + pad)
    y_j, vjp = jax.vjp(lambda a: jcommon.reflect_pad(a, pad), jnp.asarray(x))
    g = _np(y_j.shape, 7)
    xt = torch.from_numpy(x).requires_grad_()
    y = tcommon.reflect_pad(xt, pad)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(gt.numpy(), want, atol=8 * ulp, rtol=0)


def _fold_before(g, p, dim):
    """The fold the port used for pad < size before it took every size."""
    n = g.shape[dim] - 2 * p
    out = g.narrow(dim, p, n).clone()
    for j in range(p):
        out.narrow(dim, p - j, 1).add_(g.narrow(dim, j, 1))
    for j in range(p):
        out.narrow(dim, n - 2 - j, 1).add_(g.narrow(dim, p + n + j, 1))
    return out


@pytest.mark.parametrize("hw,pad", [((8, 8), 1), ((5, 7), 3), ((4, 4), 1),
                                    ((32, 32), 1), ((9, 6), 3)])
def test_pad_below_the_size_keeps_its_bits(hw, pad):
    x = torch.from_numpy(_np((2, 3, *hw), 3)).requires_grad_()
    y = tcommon.reflect_pad_nchw(x, pad)
    assert torch.equal(y, F.pad(x, (pad,) * 4, mode="reflect"))
    g = torch.from_numpy(_np(tuple(y.shape), 4))
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, _fold_before(_fold_before(g, pad, 3), pad, 2))


@pytest.mark.parametrize("n,p", [(1, 1), (1, 3), (2, 3), (3, 3), (8, 1)])
def test_reflect_index_is_numpy_s(n, p):
    assert tcommon.reflect_index(n, p) == np.pad(
        np.arange(n), p, mode="reflect").tolist()


def test_appearance_encoder_takes_a_4x4_grid():
    """The random-style re-encode of a 4 x 4 grid (``--batch_size 16``):
    1e-5, the bound of test_torch_models.py's encoder test."""
    img = np.random.default_rng(5).uniform(0, 1, (2, 4, 4, 3)).astype(
        np.float32)
    m = FlaxAppearanceEncoder(8)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(img))
    t = AppearanceEncoder(8)
    sd = bridge.state_dict_from_flax(v)
    t.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = t.eval()(torch.from_numpy(img))
    ref = np.asarray(m.apply(v, jnp.asarray(img)))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_blender_cli_trains_at_batch_size_16(tmp_path):
    """tests/test_apps.py's Blender CLI run (3 RGBA frames of 400 x 400,
    trained at 32 x 32 with color + occ perturbations, 4 x 4 grids), in
    the port on the CPU, four grids a step."""
    from crnerf_tpu_torch.apps.train import main as train_main

    root = tmp_path / "lego"
    root.mkdir()
    rng = np.random.RandomState(0)
    frames = []
    for t in range(3):
        arr = np.zeros((400, 400, 4), np.uint8)
        arr[..., :3] = rng.randint(0, 255, (400, 400, 3))
        arr[..., 3] = 255
        Image.fromarray(arr, "RGBA").save(root / f"r_{t}.png")
        pose = np.eye(4)
        pose[2, 3] = 4.0
        pose[0, 3] = 0.3 * t
        frames.append({"file_path": f"r_{t}",
                       "transform_matrix": pose.tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.6911, "frames": frames}))
    out = str(tmp_path / "out")
    state = train_main([
        "--root_dir", str(root), "--dataset_name", "blender",
        "--img_wh", "32", "32", "--data_perturb", "color", "occ",
        "--batch_size", "16", "--grids_per_step", "4", "--N_samples", "4",
        "--N_importance", "4", "--netdepth", "2", "--netwidth", "16",
        "--nerf_out_dim", "8", "--N_vocab", "8", "--appearance_wh", "32",
        "24", "--chunk", "256", "--val_chunk", "256", "--num_epochs", "1",
        "--save_dir", out, "--exp_name", "bl", "--log_every", "1000",
        "--device", "cpu"])
    assert state.step == 3 * 32 * 32 // (16 * 4)
    assert state.has_any
    assert os.path.exists(os.path.join(out, "ckpts", "bl", "weights.npz"))
