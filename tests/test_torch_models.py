"""The port's modules against their flax counterparts, weights carried
through the bridge (crnerf_tpu_torch.utils.weights), NHWC; at fp32 and at
the served compute dtype, bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models import (
    AppearanceEncoder as FlaxAppearanceEncoder,
    ContextGuidedNetwork as FlaxCGNet,
    NerfMLP as FlaxNerfMLP,
    NeuralRenderer as FlaxNeuralRenderer,
    StyleNet as FlaxStyleNet,
)
from crnerf_tpu.models import common as jcommon
from crnerf_tpu_torch.models import common as tcommon
from crnerf_tpu_torch.models.appearance import AppearanceEncoder
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.models.decoder import NeuralRenderer
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.models.style import StyleNet
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _np(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _load(module, variables):
    sd = bridge.state_dict_from_flax(variables)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _random_biases(variables, seed):
    """flax initialises biases to zero; random ones exercise where a bias
    is added (after the product's rounding at bf16)."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten(jax.tree.map(np.asarray, variables))
    for k, a in flat.items():
        if k.endswith("bias"):
            flat[k] = rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, bridge.unflatten(flat))


def _err(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return d.max(), d.mean()


# bf16 tests: both sides round to bf16 at the same points (flax's: the
# product, then the bias add, leaky_relu's bf16 slope, jax.nn.sigmoid's
# four bf16 steps, the adaptive pool's bf16 bin weights). Each tolerance
# sits between the port's error at bf16 and that of the same port module
# computed at fp32 against the same bf16 flax output (readings in each
# docstring, this CPU), so a module that skips a cast point fails it.
BF16 = torch.bfloat16


def test_nerf_mlp():
    """Skip at layer 4, fp32 softplus sigma, sigmoid features; 1e-5."""
    x, d = _np((64, 93), 1), _np((64, 27), 2)
    m = FlaxNerfMLP(depth=6, width=64, out_dim=16)
    v = m.init(KEY, jnp.asarray(x), jnp.asarray(d))
    t = _load(NerfMLP(depth=6, width=64, out_dim=16), v)
    with torch.no_grad():
        out = t(torch.from_numpy(x), torch.from_numpy(d))
    _close(out, m.apply(v, jnp.asarray(x), jnp.asarray(d)), atol=1e-5)


def test_appearance_encoder():
    """Plain schedule; 1e-5 (reflect-padded 3x3 convs, pools)."""
    img = _np((1, 48, 64, 3), 3, 0.0, 1.0)
    m = FlaxAppearanceEncoder(16)
    v = m.init(KEY, jnp.asarray(img))
    t = _load(AppearanceEncoder(16), v)
    with torch.no_grad():
        out = t(torch.from_numpy(img))
    ref = m.apply(v, jnp.asarray(img))
    assert tuple(out.shape) == (1, 32, 32, 16)
    _close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("final_act", ["sigmoid", "tanh01"])
def test_neural_renderer(final_act):
    x = _np((2, 8, 12, 16), 4)
    m = FlaxNeuralRenderer(feat_nc=16, final_act=final_act)
    v = m.init(KEY, jnp.asarray(x))
    t = _load(NeuralRenderer(16, final_act=final_act), v)
    with torch.no_grad():
        out = t(torch.from_numpy(x))
    _close(out, m.apply(v, jnp.asarray(x)), atol=1e-6)


def test_style_net_decode_batch():
    """Batched StyleTransform + decode (coarse and fine maps styled in one
    pass); gram and transmatrix in fp32; 1e-5 on rgb in [0, 1]."""
    contents = _np((2, 8, 12, 16), 5, 0.0, 1.0)
    styles = _np((2, 32, 32, 16), 6, 0.0, 1.0)
    m = FlaxStyleNet(nerf_out_dim=16)
    v = m.init(KEY, jnp.asarray(contents[:1]), jnp.asarray(styles[:1]))
    ref = m.apply(v, jnp.asarray(contents), jnp.asarray(styles),
                  method="decode_batch")
    t = _load(StyleNet(16), v)
    with torch.no_grad():
        out = t.decode_batch(torch.from_numpy(contents),
                             torch.from_numpy(styles))
        one = t(torch.from_numpy(contents[:1]), torch.from_numpy(styles[:1]))
    assert tuple(out.shape) == (2, 8, 12, 3)
    _close(out, ref, atol=1e-5)
    _close(one, ref[:1], atol=1e-5)


def _nontrivial(variables, seed):
    """Random BN scale/bias/running stats and PReLU slopes, so eval-mode
    normalisation (eps 1e-3) is exercised."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten(variables)
    for k, a in flat.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("mean", "scale", "alpha") or (
                leaf == "bias" and "BatchNorm" in k):
            flat[k] = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32) + (
                1.0 if leaf == "scale" else 0.0)
        elif leaf == "var":
            flat[k] = rng.uniform(0.2, 2.0, a.shape).astype(np.float32)
    return bridge.unflatten(flat)


def test_cgnet_eval_mode():
    img = _np((1, 48, 64, 3), 8, 0.0, 1.0)
    m = FlaxCGNet(classes=1, M=2, N=2, input_channel=3)
    v = _nontrivial(m.init(KEY, jnp.asarray(img), train=False), 9)
    ref = m.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(img),
                  train=False)
    t = _load(ContextGuidedNetwork(), v)
    with torch.no_grad():
        out = t(torch.from_numpy(img))
    assert tuple(out.shape) == (1, 48, 64, 1)
    _close(out, ref, atol=1e-5)


def test_bridge_round_trip_is_exact(tmp_path):
    """flax -> state_dict -> flax is the identity, through weights.npz."""
    img = _np((1, 48, 64, 3), 10, 0.0, 1.0)
    v = _nontrivial(FlaxCGNet().init(KEY, jnp.asarray(img), train=False), 11)
    t = _load(ContextGuidedNetwork(), v)
    path = str(tmp_path / "weights.npz")
    bridge.save_npz(bridge.flax_from_state_dict(t), path)
    back = bridge.flatten(bridge.load_npz(path))
    want = bridge.flatten(v)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_common_layout_ops():
    x = _np((1, 7, 9, 5), 12)
    xt = torch.from_numpy(x)
    _close(tcommon.max_pool_2x2(xt), jcommon.max_pool_2x2(jnp.asarray(x)),
           atol=0)
    _close(tcommon.avg_pool_3x3_s2_p1(xt),
           jcommon.avg_pool_3x3_s2_p1(jnp.asarray(x)), atol=1e-6)
    _close(tcommon.adaptive_avg_pool2d(xt, (4, 4)),
           jcommon.adaptive_avg_pool2d(jnp.asarray(x), (4, 4)), atol=1e-6)
    _close(tcommon.reflect_pad(xt, 1), jcommon.reflect_pad(jnp.asarray(x)),
           atol=0)
    # upsampling: jax.image.resize and F.interpolate agree
    _close(tcommon.resize_bilinear(xt, (21, 36)),
           jcommon.resize_bilinear(jnp.asarray(x), (21, 36)), atol=1e-6)
    uv = _np((50, 2), 13, 0.0, 1.0)
    _close(tcommon.sample_bilinear_uv(xt[0], torch.from_numpy(uv)),
           jcommon.sample_bilinear_uv(jnp.asarray(x[0]), jnp.asarray(uv)),
           atol=1e-6)


@pytest.mark.parametrize("pad", [1, 2])
def test_reflect_pad_gradient_matches_jax(pad):
    """The port's backward folds the border back in a fixed order (the CUDA
    backward adds with atomics): against JAX's vjp."""
    x = _np((2, 7, 9, 5), 40)
    y_j, vjp = jax.vjp(lambda a: jcommon.reflect_pad(a, pad), jnp.asarray(x))
    g = _np(y_j.shape, 41)
    xt = torch.from_numpy(x).requires_grad_()
    y = tcommon.reflect_pad(xt, pad)
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _close(y.detach(), y_j, atol=0)
    _close(gt, vjp(jnp.asarray(g))[0], atol=1e-6)


@pytest.mark.parametrize("out_hw", [(21, 36), (40, 72), (7, 9)])
def test_resize_bilinear_gradient_matches_jax(out_hw):
    """The port's backward is the adjoint as two float64 products (the CUDA
    backward adds with atomics): within one fp32 step of the largest
    gradient of F.interpolate's backward at float64 (measured 4.0e-7 at
    most, 9.1 the largest), and within 1e-6 of the largest of JAX's vjp,
    whose fp32 sums round at every add (measured 2.3e-7)."""
    x = _np((2, 7, 9, 3), 42)
    xt = torch.from_numpy(x).requires_grad_()
    y = tcommon.resize_bilinear(xt, out_hw)
    g = torch.from_numpy(_np(tuple(y.shape), 43))
    (gt,) = torch.autograd.grad(y, xt, g)
    xr = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    yr = torch.nn.functional.interpolate(xr, size=out_hw, mode="bilinear",
                                         align_corners=False)
    (gr,) = torch.autograd.grad(yr, xr, g.double().permute(0, 3, 1, 2))
    gr = gr.permute(0, 2, 3, 1).numpy()
    big = np.abs(gr).max()
    y32 = torch.nn.functional.interpolate(
        tcommon.nchw(torch.from_numpy(x)), size=out_hw, mode="bilinear",
        align_corners=False)
    assert torch.equal(y.detach(), tcommon.nhwc(y32))
    _close(gt, gr, atol=2.0 ** -23 * big)
    _, vjp = jax.vjp(lambda a: jcommon.resize_bilinear(a, out_hw),
                     jnp.asarray(x))
    _close(gt, vjp(jnp.asarray(g.numpy()))[0], atol=1e-6 * big)


def test_nerf_mlp_bf16():
    """Measured: max 1.2e-7 at bf16; 5.3e-3 if computed at fp32."""
    x, d = _np((256, 93), 1), _np((256, 27), 2)
    m = FlaxNerfMLP(depth=6, width=64, out_dim=16,
                    compute_dtype=jnp.bfloat16)
    v = _random_biases(m.init(KEY, jnp.asarray(x), jnp.asarray(d)), 20)
    t = _load(NerfMLP(depth=6, width=64, out_dim=16, compute_dtype=BF16), v)
    with torch.no_grad():
        out = t(torch.from_numpy(x), torch.from_numpy(d))
    _close(out, m.apply(v, jnp.asarray(x), jnp.asarray(d)), atol=1e-6)


def test_appearance_encoder_bf16():
    """The served 224x160 style image pools to 56x40, so the 32x32
    adaptive pool has bins of 3 (bf16 weight 1/3). Accumulation order differs (oneDNN vs XLA convs),
    so a few outputs land on the other bf16 neighbour and the flips
    spread. Measured: max 7.8e-3 (one ulp at values in [1, 2)), mean
    4.3e-5 at bf16; mean 2.3e-4 with exact 1/3 pool weights; max 7.4e-3,
    mean 7.3e-4 if computed at fp32. The mean bound separates them; the
    max bound is two such ulps."""
    img = _np((1, 160, 224, 3), 21, 0.0, 1.0)
    m = FlaxAppearanceEncoder(16, dtype=jnp.bfloat16)
    v = _random_biases(m.init(KEY, jnp.asarray(img)), 22)
    t = _load(AppearanceEncoder(16, dtype=BF16), v)
    with torch.no_grad():
        out = t(torch.from_numpy(img))
    assert out.dtype == torch.float32
    mx, mean = _err(out, m.apply(v, jnp.asarray(img)))
    assert mx <= 2.0 ** -6 and mean <= 1e-4, (mx, mean)


@pytest.mark.parametrize("final_act", ["sigmoid", "tanh01"])
def test_neural_renderer_bf16(final_act):
    """Measured: max 1.2e-7 at bf16; 1.6e-3 (sigmoid) and 2.4e-3 (tanh01)
    if computed at fp32."""
    x = _np((2, 8, 12, 16), 23)
    m = FlaxNeuralRenderer(feat_nc=16, final_act=final_act,
                           dtype=jnp.bfloat16)
    v = _random_biases(m.init(KEY, jnp.asarray(x)), 24)
    t = _load(NeuralRenderer(16, final_act=final_act, dtype=BF16), v)
    with torch.no_grad():
        out = t(torch.from_numpy(x))
    _close(out, m.apply(v, jnp.asarray(x)), atol=1e-6)


def test_style_net_decode_batch_bf16():
    """Grams and the transmatrix stay fp32 at bf16. Measured: max 9.2e-4,
    mean 5.8e-6 at bf16; max 1.7e-3, mean 3.4e-4 if computed at fp32. The
    mean bound separates the two; the max bound is a ceiling."""
    contents = _np((2, 8, 12, 16), 25, 0.0, 1.0)
    styles = _np((2, 32, 32, 16), 26, 0.0, 1.0)
    m = FlaxStyleNet(nerf_out_dim=16, dtype=jnp.bfloat16)
    v = _random_biases(m.init(KEY, jnp.asarray(contents[:1]),
                              jnp.asarray(styles[:1])), 27)
    ref = m.apply(v, jnp.asarray(contents), jnp.asarray(styles),
                  method="decode_batch")
    t = _load(StyleNet(16, dtype=BF16), v)
    with torch.no_grad():
        out = t.decode_batch(torch.from_numpy(contents),
                             torch.from_numpy(styles))
    mx, mean = _err(out, ref)
    assert mx <= 2e-3 and mean <= 5e-5, (mx, mean)


def test_common_bf16_rounding_points():
    """leaky_relu's slope and the adaptive pool's bin weights at bf16, as
    the JAX package's functions round them: exact."""
    x = _np((1, 41, 35, 4), 28)
    xt, xj = torch.from_numpy(x).to(BF16), jnp.asarray(x, jnp.bfloat16)
    _close(tcommon.leaky_relu(xt).float(),
           jcommon.leaky_relu(xj).astype(jnp.float32), atol=0)
    _close(tcommon.adaptive_avg_pool2d(xt, (32, 32)).float(),
           jcommon.adaptive_avg_pool2d(xj, (32, 32)).astype(jnp.float32),
           atol=0)
