"""The fused render kernel's plain version and wrapper
(crnerf_tpu_torch.ops.fused_render) against the JAX package's Pallas
kernel, run in interpret mode, and its jnp twin.

Inputs are quantized to 6 fractional bits, as in tests/test_ops.py, so
o + d*z is exact in f32 and both sides encode the same xyz (a 1-ulp xyz
difference becomes ~1e-2 in sin(2^14 x))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.ops.fused_mlp import mlp_params_from_flax
from crnerf_tpu.ops.fused_render import (
    fused_render_apply as jax_fused_render_apply,
    reference_render_apply,
)
from crnerf_tpu_torch.ops import fused_render as fr

torch.set_num_threads(2)
C = 16
DEPTH = 6  # reaches the skip layer (index 4)


def _q(x):
    return np.round(x * 64.0) / 64.0


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    n, s = 24, 16
    o = _q(rng.normal(size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = _q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(_q(rng.uniform(0, 1, (n, s)) * 4 + 0.5), -1).astype(
        np.float32)
    noise = rng.normal(size=(n, s)).astype(np.float32)
    mlp = FlaxNerfMLP(depth=DEPTH, width=64, out_dim=C)
    v = mlp.init(jax.random.PRNGKey(3), jnp.zeros((1, 93)),
                 jnp.zeros((1, 27)))
    jp = mlp_params_from_flax(v["params"], depth=DEPTH)
    tp = fr.MlpParams(*[
        tuple(torch.from_numpy(np.asarray(a)) for a in f)
        if isinstance(f, tuple) else torch.from_numpy(np.asarray(f))
        for f in jp
    ])
    return dict(o=o, d=d, z=z, noise=noise, jp=jp, tp=tp)


def _port(case, exact_encode=True, compute_dtype=torch.float32):
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, compute_dtype)
    blk, w = fr.fused_render_apply(kw, t("o"), t("d"), t("z"), t("noise"),
                                   exact_encode)
    return blk.numpy(), w.numpy()


@pytest.mark.parametrize("exact", [True, False])
def test_twin_matches_pallas_kernel_interpret(case, exact):
    """Tolerances of tests/test_ops.py: 1e-4 weights and fmap, 2e-4
    depth."""
    blk_j, w_j = jax_fused_render_apply(
        case["jp"], jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        jnp.asarray(case["z"]), jnp.asarray(case["noise"]), r_tile=8,
        interpret=True, rays_in=True, exact_encode=exact,
    )
    blk_t, w_t = _port(case, exact_encode=exact)
    assert blk_t.shape == np.asarray(blk_j).shape
    np.testing.assert_allclose(w_t, np.asarray(w_j), atol=1e-4)
    np.testing.assert_allclose(blk_t[:, :C], np.asarray(blk_j)[:, :C],
                               atol=1e-4)
    np.testing.assert_allclose(blk_t[:, C], np.asarray(blk_j)[:, C],
                               atol=2e-4)
    assert np.all(blk_t[:, C + 1:] == 0)


def test_twin_matches_jnp_twin(case):
    xyz = (case["o"][:, None] + case["d"][:, None] * case["z"][..., None])
    fmap_r, w_r, d_r = reference_render_apply(
        case["jp"], jnp.asarray(xyz), jnp.asarray(case["d"]),
        jnp.asarray(case["z"]), jnp.asarray(case["noise"]), 15, 4,
    )
    blk_t, w_t = _port(case)
    np.testing.assert_allclose(w_t, np.asarray(w_r), atol=1e-4)
    np.testing.assert_allclose(blk_t[:, :C], np.asarray(fmap_r), atol=1e-4)
    np.testing.assert_allclose(blk_t[:, C], np.asarray(d_r), atol=2e-4)


def test_twin_bf16_policy_matches_pallas_kernel(case):
    """Same dtype policy as the JAX kernel at bf16 (operands rounded at
    the same points): 2e-3 allows an fp32 sum that rounds to the other
    bf16 neighbour."""
    blk_j, w_j = jax_fused_render_apply(
        case["jp"], jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        jnp.asarray(case["z"]), jnp.asarray(case["noise"]), r_tile=8,
        interpret=True, rays_in=True, exact_encode=False,
        compute_dtype=jnp.bfloat16,
    )
    blk_t, w_t = _port(case, exact_encode=False,
                       compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(w_t, np.asarray(w_j), atol=2e-3)
    np.testing.assert_allclose(blk_t[:, :C + 1],
                               np.asarray(blk_j)[:, :C + 1], atol=2e-3)


def test_sincos_recurrence_close_to_exact():
    """The recurrence is within ~2e-4 of the exact encode at F=15 for
    |x| < 1 (the JAX package's bound)."""
    x = torch.from_numpy(
        np.random.default_rng(1).uniform(-1, 1, (256, 3)).astype(np.float32))
    a = fr.sincos_encode(x, 15, exact=True)
    b = fr.sincos_encode(x, 15, exact=False)
    assert float((a - b).abs().max()) < 5e-4
    for k in (0, 8):  # anchor octaves are exact sin/cos
        cols = slice(3 + 6 * k, 9 + 6 * k)
        assert torch.equal(a[:, cols], b[:, cols])


def test_cpu_wrapper_takes_the_plain_version(case):
    before = fr.LAUNCH_COUNTS["fused_render_fwd"]
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, torch.float32)
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    blk_a, w_a = fr.fused_render_apply(kw, t("o"), t("d"), t("z"),
                                       t("noise"))
    blk_b, w_b = fr.render_fwd_plain(case["tp"], t("o"), t("d"), t("z"),
                                     t("noise"))
    assert torch.equal(blk_a, blk_b) and torch.equal(w_a, w_b)
    assert fr.LAUNCH_COUNTS["fused_render_fwd"] == before


def test_pack_mma_b_fragment_order():
    """Lane l of tile (kt, nt) holds B[2t+{0,1}][g] and B[2t+8+{0,1}][g]
    of that tile, g = l // 4, t = l % 4."""
    b = torch.arange(32 * 16, dtype=torch.float32).reshape(32, 16)
    p = fr.pack_mma_b(b).float()
    b = b.to(torch.bfloat16).float()
    assert p.shape == (2, 2, 32, 4)
    for kt, nt, lane in [(0, 0, 0), (1, 1, 5), (1, 0, 31)]:
        g, t = lane // 4, lane % 4
        k0, n = kt * 16 + 2 * t, nt * 8 + g
        want = [b[k0, n], b[k0 + 1, n], b[k0 + 8, n], b[k0 + 9, n]]
        assert p[kt, nt, lane].tolist() == [float(v) for v in want]


@pytest.mark.parametrize("bf16", [False, True])
def test_prepare_kernel_weights_pads_and_orders(case, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = fr.prepare_kernel_weights(case["tp"], 15, 4, dt)
    assert kw.dims == dict(L=DEPTH, skip_mask=1 << 4, WP=64, HP=32, CP=32,
                           C=C, KE=96, F=15, DK=27, BF16=int(bf16))
    assert len(kw.tensors) == 9 + 3 * DEPTH
    layer = lambda i: kw.tensors[9 + 3 * i:12 + 3 * i]  # noqa: E731
    assert layer(0)[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert layer(0)[1] is None                 # no hidden operand
    assert layer(1)[0] is None                 # no encode operand
    assert all(t is not None for t in layer(4))  # the skip layer: both
    if bf16:   # (96 x 64) in 16x8 tiles of 32 lanes x 4
        assert tuple(layer(0)[0].shape) == (6, 8, 32, 4)
    else:
        assert tuple(layer(0)[0].shape) == (96, 64)
        np.testing.assert_array_equal(layer(0)[0][:93].numpy(),
                                      case["tp"].trunk_w[0].numpy())


def test_prepare_kernel_weights_rejects_unsupported(case):
    p = case["tp"]
    wide = p._replace(final_w=torch.zeros(72, 72))
    with pytest.raises(ValueError, match="width"):
        fr.prepare_kernel_weights(wide)
    with pytest.raises(ValueError, match="compute dtype"):
        fr.prepare_kernel_weights(p, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="skips"):
        fr.prepare_kernel_weights(p, skips=(0,))
