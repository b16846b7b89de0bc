"""The port's core math (crnerf_tpu_torch.core) against crnerf_tpu.core on
the same seeded numpy inputs, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.core import compositing as jcomp
from crnerf_tpu.core import encoding as jenc
from crnerf_tpu.core import rays as jrays
from crnerf_tpu.core import sampling as jsamp
from crnerf_tpu.render.inference import _cam_rays_uv
from crnerf_tpu_torch.core import compositing as tcomp
from crnerf_tpu_torch.core import encoding as tenc
from crnerf_tpu_torch.core import rays as trays
from crnerf_tpu_torch.core import sampling as tsamp

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n_freqs", [4, 15])
def test_posenc(n_freqs):
    """Interleaved order and values; 1e-5 covers sin/cos ulps at 2^14 x
    for |x| < 1."""
    x = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    _close(tenc.posenc(_t(x), n_freqs), jenc.posenc(jnp.asarray(x), n_freqs),
           atol=1e-5)


def test_ray_directions_and_rays():
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    c2w = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    d_j = jrays.get_ray_directions(24, 32, K)
    d_t = trays.get_ray_directions(24, 32, K)
    _close(d_t, d_j, atol=0)
    o_j, r_j = jrays.get_rays(d_j, c2w)
    o_t, r_t = trays.get_rays(d_t, _t(c2w))
    _close(o_t, o_j, atol=0)
    _close(r_t, r_j, atol=1e-6)


def test_cam_rays_uv_matches_device_ray_maker():
    """The serving path's on-device ray maker (elementwise rotation)."""
    rng = np.random.default_rng(2)
    c2w = rng.normal(size=(3, 4)).astype(np.float32)
    intr = np.array([40.0, 41.0, 16.0, 12.5], np.float32)
    h, w = 24, 32
    rays_j, uv_j = _cam_rays_uv(
        jnp.arange(h * w, dtype=jnp.int32), jnp.asarray(c2w),
        jnp.asarray(intr), jnp.asarray([0.5, 3.0]),
        jnp.asarray([h, w], jnp.int32), h * w,
    )
    rays_t, uv_t = trays.cam_rays_uv(_t(c2w), _t(intr), 0.5, 3.0, (h, w))
    _close(rays_t, rays_j, atol=1e-6)
    _close(uv_t, uv_j, atol=0)


@pytest.mark.parametrize("use_disp", [False, True])
def test_stratified_zvals(use_disp):
    near = np.full((5, 1), 0.5, np.float32)
    far = np.full((5, 1), 4.0, np.float32)
    _close(tsamp.stratified_zvals(_t(near), _t(far), 16, use_disp),
           jsamp.stratified_zvals(jnp.asarray(near), jnp.asarray(far), 16,
                                  use_disp), atol=1e-6)


def _pdf_inputs(n=32, b=15):
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(0.5, 4.0, (n, b + 2)), -1).astype(np.float32)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = rng.uniform(0, 1, (n, b)).astype(np.float32) ** 4
    return bins, w


def test_sample_pdf_det():
    """searchsorted + gather against the JAX one-hot form. 1e-4 on z of
    ~4: the cdf is summed in another order (XLA vs torch cumsum), and a
    bin with little mass divides that rounding by its small cdf step."""
    bins, w = _pdf_inputs()
    _close(tsamp.sample_pdf(_t(bins), _t(w), 24, det=True),
           jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 24,
                            det=True), atol=1e-4)


def test_sample_pdf_injected_u():
    """The JAX stochastic draw's own u, injected into the port (1e-4 as
    in the det case)."""
    bins, w = _pdf_inputs()
    key = jax.random.PRNGKey(7)
    e = jax.random.exponential(key, (bins.shape[0], 25), dtype=jnp.float32)
    cs = jnp.cumsum(e, -1)
    u = np.asarray(cs[:, :-1] / cs[:, -1:])
    _close(tsamp.sample_pdf(_t(bins), _t(w), 24, det=False, u=_t(u)),
           jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24,
                            det=False), atol=1e-4)


def test_sample_pdf_stochastic_needs_draws():
    bins, w = _pdf_inputs()
    with pytest.raises(ValueError, match="draws"):
        tsamp.sample_pdf(_t(bins), _t(w), 24, det=False)


def test_merge_sorted_zvals():
    rng = np.random.default_rng(4)
    zc = np.sort(rng.uniform(0, 1, (8, 16)), -1).astype(np.float32)
    zf = np.sort(rng.uniform(0, 1, (8, 16)), -1).astype(np.float32)
    _close(tsamp.merge_sorted_zvals(_t(zc), _t(zf)),
           jsamp.merge_sorted_zvals(jnp.asarray(zc), jnp.asarray(zf)),
           atol=0)


@pytest.mark.parametrize("with_noise", [False, True])
def test_composite(with_noise):
    """1e-5: cumprod order (XLA vs torch)."""
    rng = np.random.default_rng(5)
    feats = rng.uniform(0, 1, (16, 12, 8)).astype(np.float32)
    sig = rng.uniform(0, 5, (16, 12)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 4, (16, 12)), -1).astype(np.float32)
    noise = rng.normal(size=(16, 12)).astype(np.float32)
    if with_noise:
        a_j = jcomp.compute_alphas(jnp.asarray(sig + noise), jnp.asarray(z))
        w_j = jcomp.weights_from_alphas(a_j)
        fm_j = jnp.einsum("ns,nsc->nc", w_j, jnp.asarray(feats),
                          precision=jax.lax.Precision.HIGHEST)
        d_j = jnp.sum(w_j * z, -1)
    else:
        w_j, fm_j, d_j = jcomp.composite(jnp.asarray(feats),
                                         jnp.asarray(sig), jnp.asarray(z))
    w_t, fm_t, d_t = tcomp.composite(_t(feats), _t(sig), _t(z),
                                     _t(noise) if with_noise else None)
    _close(w_t, w_j, atol=1e-5)
    _close(fm_t, fm_j, atol=1e-5)
    _close(d_t, d_j, atol=1e-5)
