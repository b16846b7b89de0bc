"""The port's image metrics against crnerf_tpu.train.metrics on seeded
images: mean SSIM (HWC and NHWC) and MSE within 1e-6, PSNR within 1e-6
relative, with and without a validity mask. The JAX side filters at
Precision.HIGHEST, the port with shifted fp32 multiply-adds: only the
summation order differs.

The SSIM map is held at 1e-5 per pixel: its variance terms are differences
of fp32 window means (E[x^2] - E[x]^2), so a one-ulp difference in a window
mean becomes up to ~5e-6 where a window is nearly flat (measured 4.9e-6
between the two packages, each as far from a float64 evaluation of the same
formula). The mean over the map averages that out and holds 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.train import metrics as jm
from crnerf_tpu_torch.train import metrics as pm

TOL = 1e-6
MAP_TOL = 1e-5


def _ssim_map_f64(a, b, window, max_val):
    """The same formula in float64 numpy, NHWC."""
    k = pm._gaussian_kernel2d(window, 1.5).astype(np.float64)
    p = (window - 1) // 2

    def filt(x):
        xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
        h, w = x.shape[1:3]
        return sum(k[i, j] * xp[:, i:i + h, j:j + w]
                   for i in range(window) for j in range(window))

    a, b = a.astype(np.float64), b.astype(np.float64)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    m1, m2 = filt(a), filt(b)
    s1, s2 = filt(a * a) - m1 * m1, filt(b * b) - m2 * m2
    s12 = filt(a * b) - m1 * m2
    return ((2 * m1 * m2 + c1) * (2 * s12 + c2)
            / ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2)))


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(18, 24, 3), (2, 16, 20, 3), (5, 7, 3)])
def test_ssim_matches_jax(shape):
    a, b = _pair(shape, 0)
    want = float(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(pm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= TOL, (got, want)


@pytest.mark.parametrize("max_val,window", [(1.0, 3), (2.0, 5)])
def test_ssim_map_matches_jax(max_val, window):
    a, b = _pair((2, 12, 17, 3), 1)
    a, b = a * max_val, b * max_val
    want = np.asarray(jm.ssim_map(jnp.asarray(a), jnp.asarray(b),
                                  window_size=window, max_val=max_val))
    got = pm.ssim_map(torch.from_numpy(a), torch.from_numpy(b),
                      window_size=window, max_val=max_val).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MAP_TOL, rtol=0)
    exact = _ssim_map_f64(a, b, window, max_val)
    np.testing.assert_allclose(got, exact, atol=MAP_TOL, rtol=0)
    np.testing.assert_allclose(want, exact, atol=MAP_TOL, rtol=0)
    assert abs(float(got.mean()) - float(want.mean())) <= TOL


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _pair((10, 14, 3), 2)
    t = torch.from_numpy(a)
    assert abs(float(pm.ssim(t, t)) - 1.0) <= TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["mse", "psnr"])
def test_mse_and_psnr_match_jax(fn, masked):
    a, b = _pair((300, 3), 3)
    mask = np.random.default_rng(4).uniform(size=300) < 0.6 if masked \
        else None
    want = float(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b),
                                 None if mask is None else jnp.asarray(mask)))
    got = float(getattr(pm, fn)(torch.from_numpy(a), torch.from_numpy(b),
                                None if mask is None
                                else torch.from_numpy(mask)))
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def test_the_mask_selects_the_valid_entries():
    a, b = _pair((200, 3), 5)
    mask = np.zeros(200, bool)
    mask[:50] = True
    got = float(pm.mse(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(mask)))
    assert got == pytest.approx(float(np.mean((a[:50] - b[:50]) ** 2)),
                                rel=1e-6)
