"""The port's stand-alone compositing op (crnerf_tpu_torch.ops.composite)
on CPU tensors, where it takes its plain version, against the JAX package's
Pallas kernel in interpret mode (composite_pallas), at S and C that are not
multiples of 128 (the TPU kernel pads both; the port's kernel pads
neither). Inputs come from a numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.ops.composite import composite_pallas
from crnerf_tpu_torch.core.compositing import composite
from crnerf_tpu_torch.ops import composite as comp
from crnerf_tpu_torch.ops import composite_apply

torch.set_num_threads(2)


def _data(n, s, c, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 1, (n, s, c)).astype(np.float32)
    # a fifth of the densities negative: the clamp at 0 is part of the op
    sigmas = (rng.uniform(-0.75, 3, (n, s))).astype(np.float32)
    z = np.sort(rng.uniform(0, 1, (n, s)) * 5 + 0.5, -1).astype(np.float32)
    return feats, sigmas, z


@pytest.mark.parametrize("n,s,c", [(300, 20, 48), (37, 200, 16), (64, 1, 3),
                                   (9, 130, 129)])
def test_composite_matches_pallas_kernel(n, s, c):
    """weights and feature map 1e-6, depth 1e-5: the tolerances the JAX
    package holds its kernel to against its own twin
    (tests/test_ops.py TestCompositeKernel); the sides take the running
    product and the sums over S in another order."""
    feats, sigmas, z = _data(n, s, c)
    w_j, f_j, d_j = composite_pallas(jnp.asarray(feats), jnp.asarray(sigmas),
                                     jnp.asarray(z), ray_tile=64,
                                     interpret=True)
    before = dict(comp.LAUNCH_COUNTS)
    w_t, f_t, d_t = composite_apply(torch.from_numpy(feats),
                                    torch.from_numpy(sigmas),
                                    torch.from_numpy(z))
    assert comp.LAUNCH_COUNTS == before      # CPU: the plain version
    assert w_t.shape == (n, s) and f_t.shape == (n, c) and d_t.shape == (n,)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    ws = w_t.numpy().sum(-1)
    assert (ws <= 1 + 1e-5).all() and (ws >= 0).all()


def test_composite_is_the_deterministic_composite():
    """No noise: the op is core.compositing.composite at noise None, and a
    negative density weighs nothing."""
    feats, sigmas, z = [torch.from_numpy(a) for a in _data(12, 10, 5, 1)]
    got = composite_apply(feats, sigmas, z)
    want = composite(feats, sigmas, z, None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.all(got[0][sigmas <= 0] == 0)
    assert float(got[0][sigmas > 0].min()) > 0


def test_composite_refuses_devices_it_has_no_kernel_for():
    feats, sigmas, z = [torch.from_numpy(a).to("meta")
                        for a in _data(4, 4, 4)]
    with pytest.raises(ValueError, match="no composite kernel"):
        composite_apply(feats, sigmas, z)
