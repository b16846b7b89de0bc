"""The model zoo's tail against the JAX classes, with random weights
carried through the weight bridge, fp32, 1e-5: the decoder with upsampling
blocks (``NeuralRenderer(n_blocks > 0)``, and ``StyleNet`` over it), the
LPIPS AlexNet (``eval/lpips.py``, on a random weights file), the NeRF-W and
tanh MLPs, the RRDB decoder, ``EAttr`` and ``ImplicitMask``. None of them
lies on a system path, as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.eval import lpips as jax_lpips
from crnerf_tpu.models import decoder as jdec
from crnerf_tpu.models import esrgan as jesr
from crnerf_tpu.models import nerf_mlp as jmlp
from crnerf_tpu.models import networks as jnet
from crnerf_tpu.models.style import StyleNet as JaxStyleNet
from crnerf_tpu_torch.eval import lpips
from crnerf_tpu_torch.models import decoder, esrgan, nerf_mlp, networks
from crnerf_tpu_torch.models.style import StyleNet
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(jax_module, port_module, *inputs, seed=0, **kw):
    """Init the flax module on ``inputs``, load its variables into the port
    module, apply both -> (JAX output, port output) as numpy."""
    variables = jax_module.init(jax.random.PRNGKey(seed),
                                *map(jnp.asarray, inputs), **kw)
    bridge.load_into(port_module, jax.tree.map(np.asarray, variables))
    want = np.asarray(jax_module.apply(variables, *map(jnp.asarray, inputs),
                                       **kw))
    with torch.no_grad():
        got = port_module(*map(torch.from_numpy, inputs), **kw).numpy()
    return want, got


@pytest.mark.parametrize("n_blocks,act", [(1, "sigmoid"), (2, "tanh01"),
                                          (3, "none")])
def test_neural_renderer_with_upsampling_blocks(n_blocks, act):
    """Each block doubles the map: (2, 6, 5, 64) -> 2^n_blocks times the
    size; the block widths go 64, 32, 32 (``min_feat``)."""
    x = _rand((2, 6, 5, 64), 1)
    want, got = _pair(jdec.NeuralRenderer(feat_nc=64, n_blocks=n_blocks,
                                          final_act=act),
                      decoder.NeuralRenderer(64, 3, n_blocks, act), x)
    assert got.shape == (2, 6 << n_blocks, 5 << n_blocks, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_get_renderer_passes_the_blocks():
    r = decoder.get_renderer(64, "1-4-1", n_blocks=2)
    assert r.n_blocks == 2 and r.final_act == "tanh01"
    assert {n for n, _ in r.named_children()} >= {
        "upsample_1", "feat_1", "feat_2_rgb_2"}


def test_blur_is_the_jax_blur():
    x = _rand((1, 7, 9, 5), 2)
    want = np.asarray(jdec.Blur().apply({}, jnp.asarray(x)))
    got = decoder.blur(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_stylenet_with_upsampling_blocks_and_its_content_path():
    """StyleNet over a one-block decoder: the styled decode, the unstyled
    content decode (``style=None, kind="content"``), and the batched
    decode with the raw maps appended, each against the JAX module."""
    c, s = _rand((2, 8, 8, 32), 3), _rand((2, 32, 32, 32), 4)
    jnet_ = JaxStyleNet(nerf_out_dim=32, n_upsample_blocks=1)
    variables = jnet_.init(jax.random.PRNGKey(0), jnp.asarray(c),
                           jnp.asarray(s))
    port = bridge.load_into(StyleNet(32, n_upsample_blocks=1),
                            jax.tree.map(np.asarray, variables))
    tc, ts = torch.from_numpy(c), torch.from_numpy(s)
    with torch.no_grad():
        cases = {
            "styled": (jnet_.apply(variables, c, s), port(tc, ts)),
            "content": (jnet_.apply(variables, c, None, kind="content"),
                        port(tc, None, kind="content")),
            "batch": (jnet_.apply(variables, c, s, c[:1],
                                  method="decode_batch"),
                      port.decode_batch(tc, ts, tc[:1])),
        }
    for name, (want, got) in cases.items():
        assert got.shape[1:3] == (16, 16), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=name)
    # the appended raw map decodes as the content path does
    np.testing.assert_allclose(cases["batch"][1][2].numpy(),
                               cases["content"][1][0].numpy(), atol=1e-6)


def test_nerf_w_mlp_with_and_without_the_random_head():
    kw = dict(depth=4, width=32, skips=(2,), in_channels_xyz=21,
              in_channels_dir=9, in_channels_a=6, out_dim=3)
    xyz, d, a, ar = (_rand((10, 21), 5), _rand((10, 9), 6),
                     _rand((10, 6), 7), _rand((10, 6), 8))
    for inputs in ((xyz, d, a), (xyz, d, a, ar)):
        want, got = _pair(jmlp.NerfWMLP(**kw), nerf_mlp.NerfWMLP(**kw),
                          *inputs)
        assert got.shape == (10, 3 * (len(inputs) - 2))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_nerf_tanh_mlp(sigma_only):
    kw = dict(depth=4, width=32, skips=(2,), out_dim=8)
    xyz, d = _rand((10, 21), 9), _rand((10, 9), 10)
    jm = jmlp.NerfTanhMLP(**kw)
    variables = jm.init(jax.random.PRNGKey(0), xyz, d)
    port = bridge.load_into(
        nerf_mlp.NerfTanhMLP(in_channels_xyz=21, in_channels_dir=9, **kw),
        jax.tree.map(np.asarray, variables))
    want = np.asarray(jm.apply(variables, xyz, d, sigma_only=sigma_only))
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(d),
                   sigma_only=sigma_only).numpy()
    assert got.shape == (10, 1 if sigma_only else 9)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rrdb_net():
    x = _rand((2, 5, 6, 16), 11)
    want, got = _pair(jesr.RRDBNet(channels=16, filters=8, num_res_blocks=2),
                      esrgan.RRDBNet(16, 8, 2), x)
    assert got.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_e_attr_and_implicit_mask():
    x = _rand((2, 40, 36, 3), 12)
    want, got = _pair(jnet.EAttr(output_nc=8), networks.EAttr(3, 8), x)
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    z = _rand((7, 20), 13)
    want, got = _pair(jnet.ImplicitMask(width=32),
                      networks.ImplicitMask(20, 32), z)
    assert got.shape == (7, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _lpips_npz(path, seed=14):
    """A random weights file in the JAX package's layout: HWIO kernels at
    He scale, non-negative heads."""
    rng = np.random.default_rng(seed)
    cin, arrays = 3, {}
    for i, (c, k, _, _) in enumerate(lpips._ALEX_CONVS):
        arrays[f"conv{i}_w"] = (rng.normal(size=(k, k, cin, c))
                                * np.sqrt(2.0 / (k * k * cin))).astype(
                                    np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.1, c).astype(np.float32)
        arrays[f"lin{i}_w"] = rng.uniform(0, 1, c).astype(np.float32)
        cin = c
    np.savez(path, **arrays)
    return str(path)


def test_lpips_alex_on_a_random_weights_file(tmp_path):
    """The JAX class's score on the same file and images (1e-5 relative),
    for one image and a batch; a missing file raises FileNotFoundError in
    both, and both default to the same path."""
    path = _lpips_npz(tmp_path / "alex.npz")
    rng = np.random.default_rng(15)
    a = rng.uniform(0, 1, (2, 72, 88, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want_fn, got_fn = jax_lpips.LpipsAlex(path), lpips.LpipsAlex(path)
    for p, g in ((a[0], b[0]), (a, b)):
        want, got = want_fn(p, g), got_fn(p, g)
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=TOL)
    assert got_fn(a, a) == 0.0
    missing = str(tmp_path / "none.npz")
    for cls in (jax_lpips.LpipsAlex, lpips.LpipsAlex):
        with pytest.raises(FileNotFoundError, match="LPIPS weights"):
            cls(missing)
    assert lpips.DEFAULT_WEIGHTS == jax_lpips.DEFAULT_WEIGHTS


def test_metrics_app_scores_lpips_when_its_weights_are_there(
        tmp_path, monkeypatch, capsys):
    """With the weights file at the default path the metrics app reports
    an lpips column, the JAX score_pair's; renders of a synthetic scene
    large enough for AlexNet's taps."""
    from crnerf_tpu.apps.eval_metric import score_pair as jax_score
    from crnerf_tpu_torch.apps import eval_metric
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from crnerf_tpu_torch.utils.png import write_png

    weights = _lpips_npz(tmp_path / "lpips_alex.npz")
    monkeypatch.setattr(lpips, "DEFAULT_WEIGHTS", weights)
    scene = make_synthetic_scene(n_train=1, n_test=2, img_wh=(160, 96))
    monkeypatch.setattr(eval_metric, "load_scene_from_config",
                        lambda cfg, split: scene)
    out = tmp_path / "results" / "synthetic" / "s"
    out.mkdir(parents=True)
    rng = np.random.default_rng(16)
    renders = []
    for i, im in enumerate(scene.test_images):
        w, h = im.wh
        gt = im.rgbs.reshape(h, w, 3)
        pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1)
        write_png(str(out / f"{i:03d}.png"), pred)
        renders.append((pred, gt))
    got = eval_metric.main(["--root_dir", str(tmp_path), "--dataset_name",
                            "synthetic", "--scene_name", "s", "--save_dir",
                            str(tmp_path), "--device", "cpu"])
    assert "lpips unavailable" not in capsys.readouterr().out
    assert set(got) == {"psnr", "ssim", "mse", "lpips"}
    jfn = jax_lpips.LpipsAlex(weights)
    want = np.mean([jax_score((p * 255).astype(np.uint8) / 255.0, g,
                              jfn)["lpips"] for p, g in renders])
    np.testing.assert_allclose(got["lpips"], want, rtol=1e-4)
    line = (out / "result.txt").read_text().splitlines()[-1]
    assert "lpips=" in line
