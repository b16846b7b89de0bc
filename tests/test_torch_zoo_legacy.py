"""The last public pieces of the JAX package to find their counterparts in
the port, each against the JAX function on the same seeded numpy inputs:
the legacy linear-style-transfer pair ``Encoder3`` / ``Decoder3`` (random
weights carried through the weight bridge; the fp32 output within 1e-5 of
the largest value, the parameter gradients at float64 within 1e-9), the
NDC transform ``get_ndc_rays`` in its torch and numpy forms (1e-6
relative), and ``CosineAnnealingWeight`` (1e-7)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.core.rays import get_ndc_rays as jax_ndc
from crnerf_tpu.models import appearance as japp
from crnerf_tpu.train.losses import CosineAnnealingWeight as JaxCosine
from crnerf_tpu_torch.core.rays import get_ndc_rays, get_ndc_rays_np
from crnerf_tpu_torch.models import appearance
from crnerf_tpu_torch.train.losses import CosineAnnealingWeight
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _within(got, want, tol=TOL, what=""):
    """Largest difference within ``tol`` of ``want``'s largest entry."""
    top = float(np.abs(want).max())
    assert top > 0, what
    np.testing.assert_allclose(got, want, atol=tol * top, rtol=0,
                               err_msg=what)


def _variables(port_module, seed):
    """Random flax variables of the port module's shapes, from numpy:
    kernels N(0, 1 / fan_in), biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        scale = (1 / np.sqrt(np.prod(a.shape[:-1]))
                 if path[-1].key == "kernel" else 0.1)
        return (rng.normal(size=a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, bridge.flax_from_state_dict(port_module))


def _pair(jax_module, port_module, x, seed):
    """Random weights for the port's module and the flax module -> (fp32
    outputs of JAX and port, float64 parameter gradients of sum(out * cot)
    with a seeded cotangent of JAX and port), numpy, flat."""
    variables = _variables(port_module, seed)
    bridge.load_into(port_module, variables)
    want = np.asarray(jax.jit(jax_module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_module(torch.from_numpy(x.copy())).numpy()
    cot = _rand(want.shape, seed + 100).astype(np.float64)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # the flax ConvRefl names float32 as its compute dtype: float64
        # for the block, the program otherwise the package's
        mp.setattr(japp, "ConvRefl", functools.partial(japp.ConvRefl,
                                                      dtype=jnp.float64))
        module = type(jax_module)()
        x64 = jnp.asarray(x, jnp.float64)

        def loss(params):
            return jnp.sum(module.apply({"params": params}, x64) * cot)

        want_g = jax.jit(jax.grad(loss))(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), variables["params"]))
        want_g = bridge.flatten(jax.tree.map(np.asarray, want_g))
    assert all(a.dtype == np.float64 for a in want_g.values())
    port64 = port_module.double()
    (port64(torch.from_numpy(x.copy()).double())
     * torch.from_numpy(cot)).sum().backward()
    got_g = bridge.flatten(bridge.flax_from_state_dict(
        port64, grads=True)["params"])
    return want, got, want_g, got_g


@pytest.mark.parametrize("hw", [(32, 32), (18, 22)])
def test_encoder3_then_decoder3(hw):
    """At 18 x 22 the pools floor (9 x 11, then 4 x 5) and the decoder
    gives 16 x 20. Each module's fp32 output within 1e-5 of the largest;
    every parameter gradient at float64 within 1e-9 of the leaf's largest
    (measured ~2e-15). The gradients are held at float64 and not at fp32:
    on the 32 x 32 draw one leaky_relu input after conv4 lies closer to
    zero than the fp32 forward's error, and the two packages' fp32
    forwards put it on opposite sides, so the fp32 gradients of conv1 to
    conv4 differ far beyond 1e-5 though each is exact for its own
    forward."""
    h, w = hw
    x = np.random.default_rng(1).uniform(size=(1, h, w, 3)).astype(
        np.float32)
    want, got, want_g, got_g = _pair(japp.Encoder3(), appearance.Encoder3(),
                                     x, 0)
    assert got.shape == (1, h // 4, w // 4, 64)
    _within(got, want, what="Encoder3")
    assert set(got_g) == set(want_g) and len(want_g) == 12
    for k in want_g:
        _within(got_g[k], want_g[k], 1e-9, what=f"Encoder3 {k}")

    want, got, want_g, got_g = _pair(japp.Decoder3(), appearance.Decoder3(),
                                     want, 2)
    assert got.shape == (1, h // 4 * 4, w // 4 * 4, 3)
    _within(got, want, what="Decoder3")
    assert set(got_g) == set(want_g) and len(want_g) == 10
    for k in want_g:
        _within(got_g[k], want_g[k], 1e-9, what=f"Decoder3 {k}")


def test_decoder3_upsampling_repeats_each_pixel():
    """``up2`` is nearest-neighbour repetition on both axes, and its
    backward sums each 2 x 2 block."""
    x = torch.from_numpy(_rand((2, 3, 4, 5), 3)).requires_grad_()
    y = appearance._up2(x)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.repeat(np.repeat(x.detach().numpy(), 2, 2),
                                      2, 3))
    g = _rand(tuple(y.shape), 4)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(
        x.grad.numpy(), g.reshape(2, 3, 4, 2, 5, 2).sum((3, 5)), rtol=1e-6)


def _rays(n, seed):
    """``n`` random rays with |d_z| kept at or above 0.2 and origins in
    front of the near plane."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.maximum(np.abs(d[:, 2]), 0.2)
    return o, d


@pytest.mark.parametrize("form", ["torch", "numpy"])
def test_ndc_rays_match_on_random_rays(form):
    o, d = _rays(1000, 5)
    want = [np.asarray(a) for a in jax_ndc(378, 504, 407.5, 1.0, o, d)]
    if form == "torch":
        got = [a.numpy() for a in get_ndc_rays(
            378, 504, 407.5, 1.0, torch.from_numpy(o), torch.from_numpy(d))]
    else:
        got = get_ndc_rays_np(378, 504, 407.5, 1.0, o, d)
    for g, w, name in zip(got, want, ("rays_o", "rays_d")):
        assert g.shape == (1000, 3) and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("form", ["torch", "numpy"])
def test_ndc_on_axis_ray_stays_on_axis(form):
    """tests/test_core.py's case: the ray down -z from (0, 0, -1)."""
    o = np.array([[0.0, 0.0, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    want = [np.asarray(a) for a in jax_ndc(8, 8, 4.0, 1.0, o, d)]
    if form == "torch":
        got = [a.numpy() for a in get_ndc_rays(
            8, 8, 4.0, 1.0, torch.from_numpy(o), torch.from_numpy(d))]
    else:
        got = get_ndc_rays_np(8, 8, 4.0, 1.0, o, d)
    assert got[0].shape == (1, 3) and got[1].shape == (1, 3)
    np.testing.assert_allclose(got[0][0, :2], [0, 0], atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [0, 500, 1000, 1700, 2000])
def test_cosine_annealing_weight(t):
    """max at t = 0, the middle at t_max / 2, min at t_max, back up past
    it; a one-element tensor is read as its value."""
    want = float(JaxCosine(5e-2, 6e-3, 1000)(t))
    port = CosineAnnealingWeight(5e-2, 6e-3, 1000)
    assert isinstance(port(t), float)
    assert abs(port(t) - want) <= 1e-7
    assert port(torch.tensor(t)) == port(t)
    expected = {0: 5e-2, 500: (5e-2 + 6e-3) / 2, 1000: 6e-3,
                2000: 5e-2}.get(t)
    if expected is not None:
        assert math.isclose(port(t), expected, rel_tol=1e-12)
