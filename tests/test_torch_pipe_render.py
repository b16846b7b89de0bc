"""The pipelined fused render forward's wrapper and plain version
(crnerf_tpu_torch.ops.pipe_render) on CPU tensors, where the wrapper takes
the plain version, against the JAX spike kernel of
scripts/spike_interleave.py (``pipe_render_apply``) run under
``pltpu.force_tpu_interpret_mode()``. ``scripts/`` is no package, so the
spike is loaded by file path. Narrow widths (depth 6 reaches the skip at
4) and inputs quantized to 6 fractional bits, as in
tests/test_torch_fused_render.py, so o + d*z is exact in f32 on both
sides."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.ops import pipe_render as pr

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 16
S = 16


def _q(x):
    return np.round(x * 64.0) / 64.0


@pytest.fixture(scope="module")
def spike():
    spec = importlib.util.spec_from_file_location(
        "spike_interleave", os.path.join(REPO, "scripts",
                                         "spike_interleave.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case(spike):
    rng = np.random.default_rng(0)
    n = 32
    o = _q(rng.normal(size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = _q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(_q(rng.uniform(0, 1, (n, S)) * 3 + 0.5), -1).astype(
        np.float32)
    noise = rng.normal(size=(n, S)).astype(np.float32)
    jp = spike.make_params(jax.random.PRNGKey(3), depth=6, width=64,
                           c_out=C)
    tp = fr.MlpParams(*[
        tuple(torch.from_numpy(np.asarray(a)) for a in f)
        if isinstance(f, tuple) else torch.from_numpy(np.asarray(f))
        for f in jp
    ])
    return dict(o=o, d=d, z=z, noise=noise, jp=jp, tp=tp)


def _jax(spike, case, n, phases, r_half, dt):
    with pltpu.force_tpu_interpret_mode():
        blk, w = spike.pipe_render_apply(
            case["jp"], *(jnp.asarray(case[k][:n])
                          for k in ("o", "d", "z", "noise")),
            phases=phases, r_half=r_half, compute_dtype=dt,
            exact_encode=False)
    return np.asarray(blk), np.asarray(w)


def _port(case, n, phases, dt):
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, dt)
    blk, w = pr.pipe_render_apply(
        kw, *(torch.from_numpy(case[k][:n])
              for k in ("o", "d", "z", "noise")),
        exact_encode=False, phases=phases)
    return blk.numpy(), w.numpy()


# (phases, r_half, rays): the spike's tile is phases * r_half rays; 20 is
# no multiple of it
@pytest.mark.parametrize("phases,r_half,n", [(2, 8, 32), (4, 8, 32),
                                             (2, 8, 20)])
def test_plain_matches_spike_kernel_fp32(spike, case, phases, r_half, n):
    """fp32: K1's tolerances (KERNEL_TOL[fp32]); the two sides differ in
    summation order and sin/cos ulps only (measured ~1e-6)."""
    blk_j, w_j = _jax(spike, case, n, phases, r_half, jnp.float32)
    blk_t, w_t = _port(case, n, phases, torch.float32)
    tol_w, tol_f, tol_d = fr.KERNEL_TOL[torch.float32]
    assert blk_t.shape == blk_j.shape and w_t.shape == w_j.shape
    np.testing.assert_allclose(w_t, w_j, atol=tol_w)
    np.testing.assert_allclose(blk_t[:, :C], blk_j[:, :C], atol=tol_f)
    np.testing.assert_allclose(blk_t[:, C], blk_j[:, C], atol=tol_d)
    assert np.all(blk_t[:, C + 1:] == 0)


def test_plain_matches_spike_kernel_bf16(spike, case):
    """bf16: the same dtype policy as the JAX kernel; 2e-3 allows an fp32
    sum that rounds to the other bf16 neighbour (as
    test_twin_bf16_policy_matches_pallas_kernel)."""
    blk_j, w_j = _jax(spike, case, 32, 2, 8, jnp.bfloat16)
    blk_t, w_t = _port(case, 32, 2, torch.bfloat16)
    np.testing.assert_allclose(w_t, w_j, atol=2e-3)
    np.testing.assert_allclose(blk_t[:, :C + 1], blk_j[:, :C + 1],
                               atol=2e-3)


def test_cpu_wrapper_takes_the_plain_version(case):
    """On CPU tensors: K1's plain version's bits whatever ``phases``, and
    no launch counted."""
    before = pr.LAUNCH_COUNTS["pipe_render_fwd"]
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, torch.float32)
    t = [torch.from_numpy(case[k]) for k in ("o", "d", "z", "noise")]
    want = fr.render_fwd_plain(case["tp"], *t, 15, 4, torch.float32, False)
    for phases in (1, 3):
        got = pr.pipe_render_apply(kw, *t, exact_encode=False, phases=phases)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pr.pipe_render_plain is fr.render_fwd_plain
    assert pr.LAUNCH_COUNTS["pipe_render_fwd"] == before


def test_wrapper_refuses_other_devices_and_phases(case):
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, torch.bfloat16)
    t = [torch.from_numpy(case[k]) for k in ("o", "d", "z", "noise")]
    with pytest.raises(ValueError, match="phases"):
        pr.pipe_render_apply(kw, *t, phases=0)
    with pytest.raises(ValueError, match="device"):
        pr.pipe_render_apply(kw, *(x.to("meta") for x in t))
