"""The sincos op's plain version (crnerf_tpu_torch/ops/sincos.py) on CPU
tensors against the comparison of scripts/spike_kernel_sincos.py: jnp.sin
and jnp.cos on the spike's own inputs (uniform in [-1, 1) from
PRNGKey(0), (1024, 128), times each of its five scales), and against
float64. The spike's Pallas kernel is nested in its ``main`` and cannot be
imported; on the card the kernel is held to float64 by chip_smoke.py and
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu_torch.ops import sincos as sc

# Each side is within one ulp of the float64 value (measured 3.6e-8 for
# torch, 3.2e-8 for XLA, against an ulp of 6e-8 below 1), so they differ by
# at most two ulps below 1: 2^-23 (measured 6.0e-8, one ulp).
TOL_JAX = 2.0 ** -23


@pytest.fixture(scope="module")
def x01():
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1024, 128),
                                         minval=-1.0, maxval=1.0))


def test_scales_are_the_spikes():
    assert sc.SCALES == (5.0, 5 * 2 ** 4, 5 * 2 ** 8, 5 * 2 ** 11,
                         5 * 2 ** 14)


@pytest.mark.parametrize("scale", sc.SCALES)
def test_plain_matches_jnp(x01, scale):
    x = (x01 * scale).astype(np.float32)
    s, c = sc.sincos(torch.from_numpy(x))
    assert s.dtype == torch.float32 and tuple(s.shape) == x.shape
    assert np.abs(s.numpy() - np.asarray(jnp.sin(x))).max() <= TOL_JAX
    assert np.abs(c.numpy() - np.asarray(jnp.cos(x))).max() <= TOL_JAX


@pytest.mark.parametrize("scale", sc.SCALES)
def test_plain_within_the_kernel_bound_of_float64(x01, scale):
    """The bound chip_smoke.py holds the card's accurate variant to (two
    ulps of 1.0) holds for the plain version at every scale."""
    x = (x01 * scale).astype(np.float32)
    s, c = sc.sincos(torch.from_numpy(x))
    assert np.abs(s.numpy() - np.sin(x.astype(np.float64))).max() \
        <= sc.F64_TOL
    assert np.abs(c.numpy() - np.cos(x.astype(np.float64))).max() \
        <= sc.F64_TOL


def test_cpu_takes_the_plain_version_whatever_fast_says():
    x = torch.linspace(-100.0, 100.0, 1001)
    for fast in (False, True):
        s, c = sc.sincos(x, fast=fast)
        assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))
    with pytest.raises(ValueError, match="device"):
        sc.sincos(torch.empty(4, device="meta"))
