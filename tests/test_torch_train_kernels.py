"""The training pair of the fused render (crnerf_tpu_torch.ops.fused_render):
the plain stash forward and the plain stash backward against the JAX
package's Pallas kernels in interpret mode
(make_fused_render_train(stash=True, rays_in=True, interpret=True) under
jax.vjp), and against autograd through the plain forward.

Inputs are quantized to 6 fractional bits, as in tests/test_ops.py, so
o + d*z is exact in f32 and both sides encode the same xyz (a 1-ulp xyz
difference becomes ~1e-2 in sin(2^14 x)). The cotangents are random and
non-zero in every column, the depth column and the weights included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.ops.fused_mlp import mlp_params_from_flax
from crnerf_tpu.ops.fused_render import make_fused_render_train
from crnerf_tpu_torch.ops import fused_render as fr

torch.set_num_threads(2)
C = 16
DEPTH = 6  # reaches the skip layer (index 4)
N, S = 24, 16


def _q(x):
    return np.round(x * 64.0) / 64.0


def _torch_params(jp, requires_grad=False):
    def leaf(a):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_(requires_grad)

    return fr.MlpParams(*[tuple(leaf(a) for a in f) if isinstance(f, tuple)
                          else leaf(f) for f in jp])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    o = _q(rng.normal(size=(N, 3))).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = _q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(_q(rng.uniform(0, 1, (N, S)) * 4 + 0.5), -1).astype(
        np.float32)
    noise = rng.normal(size=(N, S)).astype(np.float32)
    g_ray = np.zeros((N, 128), np.float32)
    g_ray[:, :C + 1] = rng.normal(size=(N, C + 1)) * 0.1
    g_w = (rng.normal(size=(N, S)) * 0.1).astype(np.float32)
    mlp = FlaxNerfMLP(depth=DEPTH, width=64, out_dim=C)
    v = mlp.init(jax.random.PRNGKey(3), jnp.zeros((1, 93)),
                 jnp.zeros((1, 27)))
    jp = mlp_params_from_flax(v["params"], depth=DEPTH)
    return dict(o=o, d=d, z=z, noise=noise, g_ray=g_ray, g_w=g_w, jp=jp)


def _jax_grads(case, compute_dtype, exact):
    fn = make_fused_render_train(
        15, 4, s=S, r_tile=8, interpret=True, rays_in=True, stash=True,
        compute_dtype=compute_dtype, exact_encode=exact)
    a = lambda k: jnp.asarray(case[k])  # noqa: E731
    out, vjp = jax.vjp(
        lambda p: fn(p, a("o"), a("d"), a("z"), a("noise")), case["jp"])
    (g,) = vjp((a("g_ray"), a("g_w")))
    return out, g


def _port_grads(case, compute_dtype, exact):
    """Through the autograd Function on CPU tensors: the plain stash
    forward, then the plain stash backward."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"], requires_grad=True)
    blk, w = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"),
                                   15, 4, compute_dtype, exact)
    flat = fr.flatten_params(p)
    grads = torch.autograd.grad([blk, w], flat, [t("g_ray"), t("g_w")])
    return (blk, w), fr.unflatten_params(grads)


def _leaves(p):
    return [np.asarray(x) for x in jax.tree.leaves(tuple(p))]


NAMES = ([f"trunk_w{i}" for i in range(DEPTH)]
         + [f"trunk_b{i}" for i in range(DEPTH)]
         + ["sigma_w", "sigma_b", "final_w", "final_b", "dir_w", "dir_b",
            "feat_w", "feat_b"])


@pytest.mark.parametrize("exact", [True, False])
def test_plain_pair_matches_pallas_stash_kernels_fp32(case, exact):
    """fp32: tests/test_ops.py's tolerance for the JAX kernel against its
    own twin (1e-4 absolute, 1e-3 relative); the two sides differ in the
    order of their fp32 sums only."""
    (blk_j, w_j), g_j = _jax_grads(case, jnp.float32, exact)
    (blk_t, w_t), g_t = _port_grads(case, torch.float32, exact)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               atol=1e-4)
    np.testing.assert_allclose(blk_t.detach().numpy()[:, :C + 1],
                               np.asarray(blk_j)[:, :C + 1], atol=2e-4)
    for name, a, b in zip(NAMES, _leaves(g_j),
                          [x.numpy() for x in fr.flatten_params(g_t)]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3, err_msg=name)


def test_plain_pair_bf16_policy_matches_pallas_stash_kernels(case):
    """bf16: both sides round every product operand (dz included) to bf16
    at the same points, so they differ where an fp32 sum lands on the
    other side of a bf16 rounding boundary, and such a flip in the forward
    carries through the layers below it. Bound per tensor, relative to
    its largest gradient: 3e-2. Measured: at most 1.04e-2 between the two
    bf16 sides (trunk layer 2), while the same gradients computed at fp32
    differ from them by up to 2.0e-1 (trunk layer 0): the bound separates
    the policy from fp32."""
    _, g_j = _jax_grads(case, jnp.bfloat16, False)
    _, g_t = _port_grads(case, torch.bfloat16, False)
    _, g_f = _port_grads(case, torch.float32, False)
    worst, worst_f32 = 0.0, 0.0
    for name, a, b, f in zip(NAMES, _leaves(g_j),
                             [x.numpy() for x in fr.flatten_params(g_t)],
                             [x.numpy() for x in fr.flatten_params(g_f)]):
        scale = np.abs(a).max()
        err = np.abs(a - b).max() / scale
        worst = max(worst, err)
        worst_f32 = max(worst_f32, np.abs(a - f).max() / scale)
        assert err <= 3e-2, (name, err)
    assert worst_f32 > 3e-2, (worst, worst_f32)


def test_plain_backward_is_autograd_of_plain_forward_fp32(case):
    """At fp32 nothing is rounded, so the explicit backward equals
    autograd through render_fwd_plain up to fp32 summation order."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"], requires_grad=True)
    blk, w = fr.render_fwd_plain(p, t("o"), t("d"), t("z"), t("noise"))
    want = torch.autograd.grad([blk, w], fr.flatten_params(p),
                               [t("g_ray"), t("g_w")])
    _, got = _port_grads(case, torch.float32, True)
    for name, a, b in zip(NAMES, want, fr.flatten_params(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


def test_stash_holds_what_the_forward_consumed(case):
    """The stash rows are the forward's own ReLU outputs, hf, dd and
    encode at the compute dtype; the outputs with and without the stash
    are the same bits."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"])
    args = (p, t("o"), t("d"), t("z"), t("noise"), 15, 4, torch.bfloat16,
            False)
    blk, w = fr.render_fwd_plain(*args)
    blk_s, w_s, st = fr.render_fwd_plain(*args, stash=True)
    assert torch.equal(blk, blk_s) and torch.equal(w, w_s)
    kw = fr.prepare_kernel_weights(p, 15, 4, torch.bfloat16)
    lay = fr.grad_layout(kw.dims)
    assert st.dtype == torch.bfloat16 and st.shape == (N * S, lay.sc)
    assert lay.sc == (DEPTH + 1) * 64 + 32 + 96
    xyz = t("o")[:, None] + t("d")[:, None] * t("z")[..., None]
    enc = fr.sincos_encode(xyz.reshape(-1, 3), 15, False)
    assert torch.equal(st[:, lay.o_enc:lay.o_enc + 93],
                       enc.to(torch.bfloat16))
    assert torch.all(st[:, lay.o_enc + 93:] == 0)
    h0 = torch.relu(fr._mm(enc, p.trunk_w[0], torch.bfloat16)
                    + p.trunk_b[0]).to(torch.bfloat16)
    assert torch.equal(st[:, :64], h0)
    assert torch.all(st[:, :lay.o_hf] >= 0)   # ReLU outputs


def test_padded_units_get_exactly_zero_gradients_and_are_dropped():
    """Width 48 pads to 64, half 24 to 32, C 20 to 32: the padded rows and
    columns of the flat gradients are exactly zero, and unpack_grads
    returns the unpadded shapes."""
    from crnerf_tpu_torch.models.nerf_mlp import NerfMLP

    torch.manual_seed(0)
    m = NerfMLP(depth=3, width=48, skips=(2,), in_channels_xyz=63,
                out_dim=20)
    p = fr.mlp_params_from_module(m)
    rng = np.random.default_rng(1)
    n, s = 6, 8
    o = torch.from_numpy(_q(rng.normal(size=(n, 3))).astype(np.float32))
    d = torch.from_numpy(_q(rng.normal(size=(n, 3))).astype(np.float32))
    z = torch.from_numpy(np.sort(_q(rng.uniform(0.5, 4, (n, s))), -1).astype(
        np.float32))
    noise = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32))
    g_ray = torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32))
    g_w = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32))
    kw = fr.prepare_kernel_weights(p, 10, 4, torch.float32, (2,))
    assert (kw.dims["WP"], kw.dims["HP"], kw.dims["CP"]) == (64, 32, 32)
    _, _, st = fr.render_fwd_plain(p, o, d, z, noise, 10, 4, skips=(2,),
                                   stash=True)
    dzbuf, gb = fr.bwd_chain_plain(kw, z, noise, fr.dir_block(kw, d, True),
                                   st, g_ray, g_w)
    gw = fr.bwd_wgrad_plain(kw, st, dzbuf)
    lay = fr.grad_layout(kw.dims)
    blocks = {key: gw[off:off + k * nn].reshape(k, nn)
              for key, _, k, _, nn, off in lay.jobs}
    assert torch.all(blocks["wh", 1][48:] == 0)
    assert torch.all(blocks["wh", 1][:, 48:] == 0)
    assert torch.all(blocks["wenc", 2][63:] == 0)
    assert torch.all(blocks["wdh"][:, 24:] == 0)
    assert torch.all(blocks["wc"][24:] == 0)
    assert torch.all(blocks["wc"][:, 20:] == 0)
    assert torch.all(blocks["ws"][:, 1:] == 0)
    assert torch.all(gb[48:64] == 0) and torch.all(gb[lay.d_sig + 1:
                                                      lay.d_ddd] == 0)
    g = fr.unpack_grads(kw, gw, gb)
    for got, ref in zip(fr.flatten_params(g), fr.flatten_params(p)):
        assert got.shape == ref.shape
    assert float(g.trunk_w[2].abs().max()) > 0


def test_unused_cotangents_arrive_as_none(case):
    """A loss that reads only the feature map: autograd hands the Function
    None for the weights' cotangent; the result equals explicit zeros."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"], requires_grad=True)
    blk, w = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"))
    g_ray = t("g_ray").clone()
    g_ray[:, C] = 0
    got = torch.autograd.grad((blk * g_ray).sum(), fr.flatten_params(p))
    p2 = _torch_params(case["jp"], requires_grad=True)
    blk2, w2 = fr.fused_render_train(p2, t("o"), t("d"), t("z"), t("noise"))
    want = torch.autograd.grad([blk2, w2], fr.flatten_params(p2),
                               [g_ray, torch.zeros_like(w2)])
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_gradients_reach_the_module_parameters(case):
    """mlp_params_from_module(detach=False) keeps the (in, out) views on
    the graph: the Function's gradients land on Linear.weight (out, in),
    the skip layer's two blocks in one matrix."""
    from crnerf_tpu_torch.models.nerf_mlp import NerfMLP

    torch.manual_seed(0)
    m = NerfMLP(depth=DEPTH, width=64, out_dim=C)
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    blk, w = fr.fused_render_train(fr.mlp_params_from_module(m, False),
                                   t("o"), t("d"), t("z"), t("noise"))
    ((blk * t("g_ray")).sum() + (w * t("g_w")).sum()).backward()
    want = fr.render_bwd_plain(
        fr.mlp_params_from_module(m), t("z"), t("noise"), t("d"),
        fr.render_fwd_plain(fr.mlp_params_from_module(m), t("o"), t("d"),
                            t("z"), t("noise"), stash=True)[2],
        t("g_ray"), t("g_w"))
    assert torch.equal(m.trunk(4).weight.grad, want.trunk_w[4].T)
    assert m.trunk(4).weight.grad.shape == (64, 93 + 64)
    assert torch.equal(m.sigma.bias.grad, want.sigma_b)
    assert torch.equal(m.dir_encoding.weight.grad, want.dir_w.T)


def test_cpu_wrappers_launch_no_kernel(case):
    before = dict(fr.LAUNCH_COUNTS)
    _port_grads(case, torch.float32, True)
    assert fr.LAUNCH_COUNTS == before
    assert set(before) == {"fused_render_fwd", "fused_render_fwd_xyz",
                           "fused_render_fwd_mma", "fused_render_fwd_xyz_mma",
                           "fused_render_fwd_stash",
                           "fused_render_fwd_stash_mma", "fused_render_bwd",
                           "fused_render_bwd_mma", "fused_render_bwd_wgrad",
                           "fused_render_bwd_wgrad_mma",
                           "fused_render_bwd_wgrad_fp32",
                           "fused_render_bwd_recompute",
                           "fused_render_bwd_recompute_xyz",
                           "fused_render_bwd_recompute_mma",
                           "fused_render_bwd_recompute_xyz_mma"}


def test_tile_table_covers_every_gradient_once(case):
    kw = fr.prepare_kernel_weights(_torch_params(case["jp"]), 15, 4,
                                   torch.bfloat16)
    lay = fr.grad_layout(kw.dims)
    for tile in (128, 64):
        tab = fr._tile_table(lay, tile, "cpu").numpy()
        seen = np.zeros(lay.wt, np.int32)
        for a_col, kv, b_col, nv, off, ld in tab:
            assert a_col + kv <= lay.sc and b_col + nv <= lay.dc
            idx = off + np.arange(kv)[:, None] * ld + np.arange(nv)[None]
            seen[idx.reshape(-1)] += 1
        assert np.all(seen == 1)
