"""The encode-block assembly's plain version and wrapper
(crnerf_tpu_torch.ops.sublane_stores) on CPU tensors, where the wrapper
takes the plain version, against a jnp expression of the three modes of
scripts/spike_sublane_stores.py (its kernel is nested in ``run`` and
cannot be imported): the same blocks and, with bf16 operands and f32
accumulation, the same products. The ``dmatrix`` sum is taken at
``Precision.HIGHEST`` (the TPU kernel's default precision would use bf16
passes; the port sums in fp32). Inputs from a numpy seed: real (sin t,
cos t) states in x's rows 0-5, where the double-angle recurrence is
stable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu_torch.ops import sublane_stores as ss

torch.set_num_threads(2)
TILES = 3

# Blocks, before their bf16 rounding, against the jnp blocks, over the
# jnp blocks' largest |value|: base and stores are elementwise with the
# same roundings (measured 0); dmatrix sums 8 fp32 products in another
# order before sin (measured ~1e-7). Bound 1e-6.
TOL_BLOCKS = 1e-6
# Products over their largest |value|: one bf16 step of a block entry
# that rounds to its other neighbour, and the order of 96 fp32 sums.
TOL_PRODUCT = 2.0 ** -7 + 1e-5


def _states(seed=1, tiles=TILES):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tiles, 8, ss.T)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (tiles, 3, ss.T))
    x[:, 0:3] = np.sin(theta)
    x[:, 3:6] = np.cos(theta)
    return x.reshape(tiles * 8, ss.T)


def _w(seed=0):
    w = np.random.default_rng(seed).standard_normal((ss.ROWS, ss.N_OUT))
    return np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))


def _jnp_blocks(x, mode):
    xt = jnp.asarray(x).reshape(-1, 8, ss.T)
    blk = jnp.zeros((xt.shape[0], ss.ROWS, ss.T), jnp.float32)
    if mode == "base":
        return blk.at[:, 0:8].set(xt)
    if mode == "stores":
        s, c = xt[:, 0:3], xt[:, 3:6]
        for k in range(ss.STEPS):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            blk = blk.at[:, 3 * k:3 * k + 3].set(s)
            blk = blk.at[:, 45 + 3 * k:48 + 3 * k].set(c)
        return blk.at[:, 90:93].set(xt[:, 0:3])
    d = jax.lax.broadcasted_iota(jnp.int32, (ss.ROWS, 8), 0).astype(
        jnp.float32) * 0.01
    args = jnp.einsum("rk,ikt->irt", d, xt,
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.sin(args)


def _jnp_product(blk, w):
    return jax.lax.dot_general(
        blk.astype(jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).reshape(-1, ss.N_OUT)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("mode", ss.MODES)
def test_plain_blocks_and_products_match_jnp(mode):
    x, w = _states(), _w()
    blk_j = _jnp_blocks(x, mode)
    blk_t = ss.sublane_blocks_plain(torch.from_numpy(x), mode)
    assert blk_t.shape == (TILES, ss.ROWS, ss.T)
    assert np.isfinite(blk_t.numpy()).all()
    assert _rel(blk_t.numpy(), blk_j) <= TOL_BLOCKS
    out_t = ss.sublane_stores(torch.from_numpy(x),
                              torch.from_numpy(w).bfloat16(), mode)
    assert out_t.shape == (TILES * ss.T, ss.N_OUT)
    assert out_t.dtype == torch.float32
    assert _rel(out_t.numpy(), _jnp_product(blk_j, w)) <= TOL_PRODUCT


@pytest.mark.parametrize("mode,rows", [("base", range(8, 96)),
                                       ("stores", range(93, 96))])
def test_zero_rows(mode, rows):
    """The rows the TPU kernel leaves unwritten are zero here: in the
    block, and so in the product with a w that is zero elsewhere."""
    x = torch.from_numpy(_states())
    blk = ss.sublane_blocks_plain(x, mode)
    assert not blk[:, list(rows)].any()
    assert blk[:, [r for r in range(ss.ROWS) if r not in rows]].any()
    w = torch.zeros((ss.ROWS, ss.N_OUT), dtype=torch.bfloat16)
    w[list(rows)] = torch.from_numpy(_w())[list(rows)].bfloat16()
    assert not ss.sublane_stores(x, w, mode).any()


@pytest.mark.parametrize("mode", ss.MODES)
def test_kernel_blocks_reads_back_the_bf16_blocks(mode):
    """The product with w = [I | 0] returns each bf16 block entry exactly,
    so the card checks can compare the kernel's blocks themselves."""
    x = torch.from_numpy(_states())
    want = ss.sublane_blocks_plain(x, mode).to(torch.bfloat16).float()
    assert torch.equal(ss.kernel_blocks(x, mode), want)


def test_stores_limits_catch_a_fused_recurrence():
    """A recurrence that rounds 2sc and 1 - 2s^2 once each (as an FMA
    does) instead of after every product drifts past both of
    ``stores``'s limits on real (sin, cos) states: the blocks lose the
    same bits and the output moves far beyond KERNEL_TOL."""
    x = _states()
    xt = x.reshape(-1, 8, ss.T)
    s, c = xt[:, 0:3], xt[:, 3:6]
    blk = np.zeros((TILES, ss.ROWS, ss.T), np.float32)
    for k in range(ss.STEPS):
        two_s = (2.0 * s).astype(np.float64)
        s, c = ((two_s * c).astype(np.float32),
                (1.0 - two_s * s).astype(np.float32))
        blk[:, 3 * k:3 * k + 3] = s
        blk[:, 45 + 3 * k:48 + 3 * k] = c
    blk[:, 90:93] = xt[:, 0:3]
    fused = torch.from_numpy(blk).bfloat16().float()
    want = ss.sublane_blocks_plain(torch.from_numpy(x),
                                   "stores").bfloat16().float()
    assert float((fused - want).abs().max()) > ss.BLOCK_TOL["stores"]
    w = torch.from_numpy(_w())
    out = (fused.transpose(1, 2) @ w).reshape(-1, ss.N_OUT)
    assert _rel(out.numpy(), (want.transpose(1, 2) @ w).reshape(
        -1, ss.N_OUT).numpy()) > 100 * ss.KERNEL_TOL["stores"]


def test_stores_overflow_on_the_spikes_own_inputs():
    """On N(0, 1) rows the recurrence is no (sin, cos) pair and blows up:
    most of the block's later rows are inf or NaN (the kernel computes the
    same; the spike's inputs serve for timing only)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, ss.T)).astype(np.float32))
    blk = ss.sublane_blocks_plain(x, "stores")
    assert (~torch.isfinite(blk[0, 42:45])).float().mean() > 0.5


def test_cpu_wrapper_takes_the_plain_version():
    before = ss.LAUNCH_COUNTS["sublane_stores"]
    x = torch.from_numpy(_states(tiles=1))
    w = torch.from_numpy(_w()).bfloat16()
    for mode in ss.MODES:
        assert torch.equal(ss.sublane_stores(x, w, mode),
                           ss.sublane_stores_plain(x, w, mode))
    assert ss.LAUNCH_COUNTS["sublane_stores"] == before
    with pytest.raises(ValueError, match="mode"):
        ss.sublane_stores(x, w, "other")
    with pytest.raises(ValueError, match="device"):
        ss.sublane_stores(x.to("meta"), w.to("meta"), "base")
