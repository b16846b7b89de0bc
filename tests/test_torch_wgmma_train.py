"""The host side of the stash route's two wgmma kernels
(crnerf_tpu_torch/ops/fused_render.py) on the CPU: the chain kernel's
transposed weight stream unpacks to the padded W^T matrices bit for bit,
the chain's variant is chosen by dtype, width, depth and samples, the
stash training forward and chain ask for the wgmma kernels at the served
widths while the no-stash forward asks for mma.sync, a step's streams
follow its parameters after an optimizer update, the CPU wrappers launch
nothing; and the stash pair at the served widths (WP 256, HP 128, CP 64)
against the JAX package's Pallas stash kernels in interpret mode."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.ops.fused_mlp import mlp_params_from_flax
from crnerf_tpu.ops.fused_render import make_fused_render_train
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_render as fr
from test_torch_wgmma_render import _params, _rays, _unpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
_RENDER_FWD, _BWD_CHAIN = fr.render_fwd, fr.bwd_chain


def _chain_matrices(kw):
    """The chain stream cut back into its (K, N) matrices, in its order,
    beside what each must be: the padded matrix or its transpose, at
    bf16."""
    d, pad = kw.dims, kw.padded
    r = lambda m: m.to(torch.bfloat16).float()   # noqa: E731
    want = [("ws", r(pad["ws"][:, :fr.WGMMA_SIGMA_N])), ("wc", r(pad["wc"])),
            ("wc^T", r(pad["wc"].T)), ("wdh^T", r(pad["wdh"].T)),
            ("wf^T", r(pad["wf"].T))]
    want += [(f"wh{i}^T", r(pad["wh", i].T))
             for i in range(d["L"] - 1, 0, -1)]
    stream = fr.wgmma_chain_weights(kw)
    off, out = 0, []
    for name, m in want:
        k, n = m.shape
        out.append((name, _unpack(stream[off:off + k * n], k, n), m))
        off += k * n
    assert off == stream.numel()
    return out


@pytest.mark.parametrize("depth,width,c,dims", [
    (8, 256, 64, dict(WP=256, HP=128, CP=64, L=8)),
    (5, 240, 40, dict(WP=256, HP=128, CP=64, L=5)),   # ragged widths
])
def test_chain_stream_unpacks_to_the_transposed_padded_matrices(depth, width,
                                                                c, dims):
    kw = fr.prepare_kernel_weights(_params(depth, width, c), 15, 4,
                                   torch.bfloat16)
    assert {k: kw.dims[k] for k in dims} == dims
    assert fr.chain_variant(kw.dims, 128) == "wgmma"
    assert kw.derived == {}     # nothing is gathered before its first use
    stream = fr.wgmma_chain_weights(kw)
    assert stream.dtype == torch.bfloat16
    assert fr.wgmma_chain_weights(kw) is stream is kw.derived["wgmma_chain"]
    for name, got, want in _chain_matrices(kw):
        assert torch.equal(got, want), name
    # the forward's stream comes from the same flat copy, gathered apart
    fwd = fr.wgmma_weights(kw)
    assert fwd is kw.derived["wgmma"] and fwd.data_ptr() != stream.data_ptr()


def test_pack_wgmma_b_is_one_gather_of_a_cached_index():
    b = torch.randn(192, 40)
    assert torch.equal(_unpack(fr.pack_wgmma_b(b), 192, 40), b)
    assert fr._swizzle_index(192, 40) is fr._swizzle_index(192, 40)
    # integer positions pack as values do: what the streams' index is
    pos = torch.arange(192 * 40).reshape(192, 40)
    assert torch.equal(fr.pack_wgmma_b(pos).float(), fr.pack_wgmma_b(
        pos.float()))


@pytest.mark.parametrize("depth,width,c,dt,s,want", [
    (8, 256, 64, torch.bfloat16, 128, "wgmma"),    # the step's fine pass
    (8, 256, 64, torch.bfloat16, 64, "wgmma"),     # coarse: two rays a tile
    (8, 256, 64, torch.bfloat16, 256, "wgmma"),    # the scan's 256 samples
    (8, 256, 64, torch.bfloat16, 257, "mma"),
    (3, 240, 40, torch.bfloat16, 100, "wgmma"),    # pads to 256 / 128 / 64
    (9, 256, 64, torch.bfloat16, 128, "mma"),      # the bias sums' room
    (8, 256, 64, torch.float32, 128, "mma"),       # no IEEE fp32 wgmma
    (8, 256, 128, torch.bfloat16, 128, "mma"),     # CP 128
    (4, 128, 64, torch.bfloat16, 128, "mma"),      # WP 128
    (6, 64, 16, torch.bfloat16, 128, "mma"),       # WP 64
])
def test_chain_variant_by_dtype_width_depth_and_samples(depth, width, c, dt,
                                                        s, want):
    kw = fr.prepare_kernel_weights(_params(depth, width, c), 15, 4, dt)
    assert fr.chain_variant(kw.dims, s) == want
    assert kw.derived == {}     # the choice packs nothing


def _spy_step(monkeypatch, stash, module=None):
    """One fused_render_train forward and backward at the served widths
    (bf16, depth 3) with the forward's and the chain's wrappers watched:
    -> (forward calls (layout, variant named, variant by shape), chain
    calls (variant named, variant by shape))."""
    fwd, chain = [], []
    real_fwd, real_chain = _RENDER_FWD, _BWD_CHAIN

    def spy_fwd(kw, *args, **kwargs):
        fwd.append((kw, kwargs.get("variant"), fr.render_variant(kw.dims)))
        return real_fwd(kw, *args, **kwargs)

    def spy_chain(kw, z, *args, **kwargs):
        chain.append((args[5] if len(args) > 5 else kwargs.get("variant"),
                      fr.chain_variant(kw.dims, z.shape[1])))
        return real_chain(kw, z, *args, **kwargs)

    monkeypatch.setattr(fr, "render_fwd", spy_fwd)
    monkeypatch.setattr(fr, "bwd_chain", spy_chain)
    if module is None:
        torch.manual_seed(0)
        module = NerfMLP(depth=3, width=256, out_dim=64)
    p = fr.mlp_params_from_module(module, detach=False)
    o, d, z, noise = _rays(4, 16)
    out, w = fr.fused_render_train(p, o, d, z, noise,
                                   compute_dtype=torch.bfloat16,
                                   exact_encode=False, stash=stash)
    ((out[:, :65] ** 2).sum() + w.sum()).backward()
    assert out.shape == (4, 128) and w.shape == (4, 16)
    return fwd, chain


@pytest.mark.parametrize("stash", [True, False])
def test_backward_chain_goes_by_shape(monkeypatch, stash):
    """The stash backward's chain takes its kernel by shape, the wgmma one
    at the served widths; the no-stash backward (the recompute) runs no
    separate chain. On CPU tensors no weight stream is gathered."""
    fwd, chain = _spy_step(monkeypatch, stash)
    assert chain == ([(None, "wgmma")] if stash else [])
    assert fwd[0][0].derived == {}


def test_stash_step_streams_follow_the_parameters(monkeypatch):
    """The layout a step makes holds that step's parameters: its forward
    and chain streams unpack to the module's weights as the step saw them,
    and after an optimizer update the next step's streams to the updated
    ones."""
    torch.manual_seed(3)
    m = NerfMLP(depth=3, width=256, out_dim=64)
    opt = torch.optim.SGD(m.parameters(), lr=0.5)
    bf = lambda t: t.detach().to(torch.bfloat16).float()   # noqa: E731
    streams = []
    for _ in range(2):
        opt.zero_grad()
        fwd, _ = _spy_step(monkeypatch, True, m)
        kw = fwd[0][0]
        chain = {name: got for name, got, _ in _chain_matrices(kw)}
        assert torch.equal(chain["wf^T"], bf(m.xyz_encoding_final.weight))
        assert torch.equal(chain["wh2^T"], bf(m.trunk(2).weight))
        enc0 = _unpack(fr.wgmma_weights(kw)[:fr.WGMMA_KE * 256],
                       fr.WGMMA_KE, 256)
        assert torch.equal(enc0[:93], bf(m.trunk(0).weight.T))
        streams.append((fr.wgmma_weights(kw), fr.wgmma_chain_weights(kw)))
        opt.step()
    for a, b in zip(*streams):
        assert not torch.equal(a, b)


def test_chain_wrapper_on_cpu_launches_nothing_and_refuses_other_shapes():
    p = _params(3, 256, 64)
    kw = fr.prepare_kernel_weights(p, 15, 4, torch.bfloat16)
    o, d, z, noise = _rays(5, 70)
    _, _, st = fr.render_fwd_plain(p, o, d, z, noise, 15, 4, torch.bfloat16,
                                   False, stash=True)
    g = np.random.default_rng(4)
    g_ray = torch.from_numpy(g.normal(0, 0.1, (5, 128)).astype(np.float32))
    g_w = torch.from_numpy(g.normal(0, 0.1, (5, 70)).astype(np.float32))
    dir_blk = fr.dir_block(kw, d, False)
    before = dict(fr.LAUNCH_COUNTS)
    want = fr.bwd_chain_plain(kw, z, noise, dir_blk, st, g_ray, g_w)
    for variant in ("wgmma", "mma", None):
        dz, gb = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w,
                              variant=variant)
        assert torch.equal(dz, want[0]) and torch.equal(gb, want[1])
    grads = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, False,
                                variant="wgmma")
    assert torch.isfinite(grads.final_w).all()
    assert fr.LAUNCH_COUNTS == before
    assert kw.derived == {}     # the plain version needs no stream
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w, variant="tma")
    kw32 = fr.prepare_kernel_weights(p, 15, 4, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fr.bwd_chain(kw32, z, noise, dir_blk, st.float(), g_ray, g_w,
                     variant="wgmma")


# ---------------------------------------------- the pair against Pallas
C, DEPTH, N, S = 64, 3, 6, 16


def _q(x):
    return np.round(x * 64.0) / 64.0


@pytest.fixture(scope="module")
def served():
    """Inputs quantized to 6 fractional bits (o + d*z exact in f32) and a
    flax MLP at the served widths (8x256 cut to depth 3, C 64)."""
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
    mlp = FlaxNerfMLP(depth=DEPTH, width=256, out_dim=C)
    v = mlp.init(jax.random.PRNGKey(5), jnp.zeros((1, 93)),
                 jnp.zeros((1, 27)))
    jp = mlp_params_from_flax(v["params"], depth=DEPTH)
    return dict(o=o, d=d, z=z, noise=noise, g_ray=g_ray, g_w=g_w, jp=jp)


def _jax_pair(case, compute_dtype, exact):
    fn = make_fused_render_train(
        15, 4, s=S, r_tile=8, interpret=True, rays_in=True, stash=True,
        compute_dtype=compute_dtype, exact_encode=exact)
    a = lambda k: jnp.asarray(case[k])  # noqa: E731
    out, vjp = jax.vjp(
        lambda p: fn(p, a("o"), a("d"), a("z"), a("noise")), case["jp"])
    (g,) = vjp((a("g_ray"), a("g_w")))
    return out, [np.asarray(x) for x in jax.tree.leaves(tuple(g))]


def _port_pair(case, compute_dtype, exact):
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = fr.MlpParams(*[
        tuple(torch.from_numpy(np.array(a)).requires_grad_(True) for a in f)
        if isinstance(f, tuple)
        else torch.from_numpy(np.array(f)).requires_grad_(True)
        for f in case["jp"]])
    kw = fr.prepare_kernel_weights(p, 15, 4, compute_dtype)
    want = "wgmma" if compute_dtype == torch.bfloat16 else "mma"
    assert fr.render_variant(kw.dims) == fr.chain_variant(
        kw.dims, S) == want
    blk, w = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"),
                                   15, 4, compute_dtype, exact)
    flat = fr.flatten_params(p)
    grads = torch.autograd.grad([blk, w], flat, [t("g_ray"), t("g_w")])
    return (blk, w), [x.numpy() for x in grads]


def test_stash_pair_at_served_widths_matches_pallas_fp32(served):
    """fp32, exact encode: tests/test_ops.py's tolerance for the JAX kernel
    against its own twin (1e-4 absolute, 1e-3 relative)."""
    (blk_j, w_j), g_j = _jax_pair(served, jnp.float32, True)
    (blk_t, w_t), g_t = _port_pair(served, torch.float32, True)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               atol=1e-4)
    np.testing.assert_allclose(blk_t.detach().numpy()[:, :C + 1],
                               np.asarray(blk_j)[:, :C + 1], atol=2e-4)
    for i, (a, b) in enumerate(zip(g_j, g_t)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3, err_msg=i)


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from crnerf_tpu.ops.fused_mlp import MlpParams
from crnerf_tpu.ops.fused_render import make_fused_render_train
inp = dict(np.load(sys.argv[1]))
depth, s = int(inp["depth"]), int(inp["s"])
leaves = [jnp.asarray(inp[f"p{i}"]) for i in range(2 * depth + 8)]
jp = MlpParams(tuple(leaves[:depth]), tuple(leaves[depth:2 * depth]),
               *leaves[2 * depth:])
a = lambda k: jnp.asarray(inp[k])
fn = make_fused_render_train(15, 4, s=s, r_tile=8, interpret=True,
                             rays_in=True, stash=True,
                             compute_dtype=jnp.bfloat16, exact_encode=False)
_, vjp = jax.vjp(lambda p: fn(p, a("o"), a("d"), a("z"), a("noise")), jp)
g = jax.tree.leaves(tuple(vjp((a("g_ray"), a("g_w")))[0]))
np.savez(sys.argv[2], **{f"g{i}": np.asarray(x) for i, x in enumerate(g)})
"""


def test_stash_pair_at_served_widths_matches_pallas_bf16(served,
                                                          tmp_path):
    """bf16, the recurrence, the JAX side in a process with XLA's excess
    precision off (XLA on the CPU otherwise drops bf16 roundings the
    program has). Both sides round every product operand to bf16 at the
    same points; where an fp32 sum lands on the other side of a rounding
    boundary a ReLU mask or a rounded value flips, and at 96 points one
    point's term is a large share of a 256-wide layer's gradient (about
    1/sqrt(points)). Measured, per tensor over its largest value: 3.1e-2
    here (trunk layer 2), 2.0e-6 and 4.2e-3 with two other seeds; the port
    at fp32 against the same JAX gradients 1.1e-1 to 1.8e-1. Bound 6e-2,
    and the fp32 gradients must lie beyond it: the bound tells the policy
    from fp32."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(tuple(served["jp"]))]
    np.savez(tmp_path / "in.npz", depth=DEPTH, s=S,
             **{k: served[k] for k in ("o", "d", "z", "noise", "g_ray",
                                       "g_w")},
             **{f"p{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BF16, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")
    g_j = [ref[f"g{i}"] for i in range(len(leaves))]
    _, g_t = _port_pair(served, torch.bfloat16, False)
    _, g_f = _port_pair(served, torch.float32, False)
    worst_f32 = 0.0
    for i, (a, b, f) in enumerate(zip(g_j, g_t, g_f)):
        assert a.shape == b.shape, i
        scale = np.abs(a).max()
        err = np.abs(a - b).max() / scale
        worst_f32 = max(worst_f32, np.abs(a - f).max() / scale)
        assert err <= 6e-2, (i, err)
    assert worst_f32 > 6e-2, worst_f32


def test_step_ab_stops_without_a_card(capsys, tmp_path):
    """The parent-against-change step timer needs the card: without one
    it stops at start and prints no reading."""
    from crnerf_tpu_torch.tools import step_ab

    assert step_ab.main([str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA device" in out.err
