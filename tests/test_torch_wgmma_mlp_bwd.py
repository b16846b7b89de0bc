"""The host side of the per-point backward's two variants
(crnerf_tpu_torch/ops/fused_mlp.py) on the CPU: the backward's variant,
and so route C's training forward's, is chosen by dtype, width and depth;
the wgmma chain's weight stream (the fused render chain's, read from past
its sigma columns) unpacks to the padded transposed matrices bit for bit;
the wgmma slab is a whole number of the kernels' waves; mlp_bwd refuses a
variant the shape does not take; both variants give the plain version on
CPU tensors and launch nothing; and, at the served widths (WP 256, HP 128,
CP 64, depth 3), the per-point backward against make_fused_mlp_train's VJP
with the Pallas kernels in interpret mode, at fp32 and at bf16, with the
bounds tests/test_torch_fused_mlp.py holds the plain backward to."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.ops.fused_mlp import make_fused_mlp_train
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr
from test_torch_fused_mlp import _JAX_BF16
from test_torch_wgmma_mlp import _points, _points_of, _port_params
from test_torch_wgmma_render import _params
from test_torch_wgmma_train import (  # noqa: F401
    C, DEPTH, N, S, _chain_matrices, served)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


@pytest.mark.parametrize("depth,width,c,dt,n_dir,want", [
    (8, 256, 64, torch.bfloat16, 4, "wgmma"),    # the served MLPs
    (3, 240, 40, torch.bfloat16, 4, "wgmma"),    # pads to 256 / 128 / 64
    (9, 256, 64, torch.bfloat16, 4, "mma"),      # the chain's sums
    (8, 256, 64, torch.float32, 4, "mma"),       # no IEEE fp32 wgmma
    (8, 256, 128, torch.bfloat16, 4, "mma"),     # CP 128
    (3, 128, 64, torch.bfloat16, 4, "mma"),      # WP 128
    (4, 256, 64, torch.bfloat16, 11, "mma"),     # DK 69: no one slice
])
def test_mlp_bwd_variant_by_shape(depth, width, c, dt, n_dir, want):
    """The backward, and so route C's training forward, take wgmma where
    the wgmma forward takes the shape and the trunk has at most
    WGMMA_CHAIN_MAX_L layers: else the mma.sync pair, forward included."""
    torch.manual_seed(0)
    p = fr.mlp_params_from_module(NerfMLP(
        depth=depth, width=width, out_dim=c, in_channels_dir=3 + 6 * n_dir))
    mkw = fm.prepare_mlp_weights(p, 15, n_dir, dt)
    assert fm.mlp_bwd_variant(mkw.kw.dims) == want
    if want == "wgmma":
        assert fm.mlp_variant(mkw.kw.dims) == "wgmma"
    assert mkw.kw.derived == {}     # the choice packs nothing


@pytest.mark.parametrize("depth,width,c,dims", [
    (8, 256, 64, dict(WP=256, HP=128, CP=64, L=8)),
    (3, 240, 40, dict(WP=256, HP=128, CP=64, L=3)),   # ragged widths
])
def test_mlp_chain_stream_unpacks_to_the_transposed_matrices(depth, width,
                                                             c, dims):
    """The wgmma chain's stream is the fused render chain's, packed once a
    layout; from past its sigma columns (the kernel's ChainStream::WC
    bytes: the fp32 sigma head reads the unrounded row instead) it is the
    feature head, then W^T of the feature head, the dir layer's hidden
    rows, the final layer and trunk layers L-1 .. 1, each the padded
    matrix at bf16, bit for bit."""
    mkw = fm.prepare_mlp_weights(_params(depth, width, c), 15, 4,
                                 torch.bfloat16)
    assert {k: mkw.kw.dims[k] for k in dims} == dims
    assert fm.mlp_bwd_variant(mkw.kw.dims) == "wgmma"
    assert mkw.kw.derived == {}
    stream = fr.wgmma_chain_weights(mkw.kw)
    assert fr.wgmma_chain_weights(mkw.kw) is stream
    mats = _chain_matrices(mkw.kw)
    assert mats[0][0] == "ws"
    wp = dims["WP"]
    assert mats[0][1].numel() * 2 == (wp // 64) * fr.WGMMA_SIGMA_N * 128
    assert [name for name, _, _ in mats[1:5]] == ["wc", "wc^T", "wdh^T",
                                                  "wf^T"]
    assert len(mats) == 5 + depth - 1
    for name, got, want in mats[1:]:
        assert torch.equal(got, want), name


@pytest.mark.parametrize("n_sm", [132, 114, 7])
def test_mlp_wgmma_slab_is_whole_waves(monkeypatch, n_sm):
    """On a card the wgmma backward's slab is a whole number of its
    kernels' waves of 128-point tiles (n_sm of them) for any budget that
    holds one; below it the budget's points; the whole run when it fits;
    the mma.sync pair keeps its own rule, whole grids of 64-point tiles."""
    monkeypatch.setattr(fm, "_sm_count", lambda dev: n_sm)
    monkeypatch.setattr(fr, "_sm_count", lambda dev: n_sm)
    mkw = fm.prepare_mlp_weights(_params(8, 256, 64), 15, 4, torch.bfloat16)
    assert fm.mlp_bwd_variant(mkw.kw.dims) == "wgmma"
    lay = fm.mlp_grad_layout(mkw.kw.dims)
    per_point = (lay.sc + lay.dc) * 2
    wave = 128 * n_sm
    for budget_points in (wave, 3 * wave + 5, 13 * wave - 1):
        p = fm.slab_points_for(mkw, 10 ** 7, "cuda",
                               per_point * budget_points)
        assert p % wave == 0 and 0 < p <= budget_points
        assert budget_points - p < wave
    for budget_points in (wave - 1, 3):
        assert fm.slab_points_for(mkw, 10 ** 7, "cuda",
                                  per_point * budget_points) == budget_points
    assert fm.slab_points_for(mkw, 5, "cuda", per_point * wave) == 5
    p = fm.slab_points_for(mkw, 10 ** 7, "cuda", per_point * (3 * wave + 5),
                           variant="mma")
    assert p % (64 * fr._chain_grid(mkw.kw, p, "cuda")[0]) == 0


def _bwd_inputs(m, c=64, seed=3):
    rng = np.random.default_rng(seed)
    g_feat = torch.from_numpy((rng.normal(size=(m, c)) * 0.1).astype(
        np.float32))
    g_sig = torch.from_numpy((rng.normal(size=m) * 0.1).astype(np.float32))
    return g_feat, g_sig


def test_mlp_bwd_refuses_a_variant_the_shape_does_not_take():
    xyz, d = _points(3, 8)
    g_feat, g_sig = _bwd_inputs(24)
    mkw32 = fm.prepare_mlp_weights(_params(3, 256, 64), 15, 4, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fm.mlp_bwd(mkw32, xyz, d, g_feat, g_sig, False, 8, variant="wgmma")
    deep = fm.prepare_mlp_weights(_params(9, 256, 64), 15, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        fm.mlp_bwd(deep, xyz, d, g_feat, g_sig, False, 8, variant="wgmma")
    mkw = fm.prepare_mlp_weights(_params(3, 256, 64), 15, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, 8, variant="tma")


def test_both_mlp_bwd_variants_give_the_plain_version_on_cpu():
    """Named or by shape, the backward on CPU tensors is the plain version
    (slab by slab) and launches nothing; the forward's stash form on CPU
    tensors is the plain stash forward."""
    mkw = fm.prepare_mlp_weights(_params(3, 256, 64), 15, 4, torch.bfloat16)
    xyz, d = _points(5, 70)
    g_feat, g_sig = _bwd_inputs(350)
    before = dict(fm.LAUNCH_COUNTS)
    want = fm.mlp_bwd_slabs_plain(mkw, xyz, d, g_feat, g_sig, False, 70, 100)
    for variant in ("wgmma", "mma", None):
        gw, gb, (st, dz) = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, 70,
                                      100, variant=variant)
        assert torch.equal(gw, want[0]) and torch.equal(gb, want[1])
        assert torch.equal(st, want[2][0]) and torch.equal(dz, want[2][1])
    f, s, st = fm.mlp_fwd(mkw, xyz, d, False, 70, stash=True)
    plain = fm.mlp_fwd_plain(mkw, xyz, d, False, 70, stash=True)
    for a, b in zip((f, s, st), plain):
        assert torch.equal(a, b)
    assert fm.LAUNCH_COUNTS == before
    assert mkw.kw.derived == {}


# ------------------------------------------- the served widths vs Pallas
def _port_grads(case, dt, exact, g):
    """Through the autograd Function on CPU tensors: the plain forward and
    the plain backward, at the backward's variant (checked: wgmma at
    bf16)."""
    p = _port_params(case["jp"], requires_grad=True)
    mkw = fm.prepare_mlp_weights(p, 15, 4, dt)
    assert fm.mlp_bwd_variant(mkw.kw.dims) == (
        "wgmma" if dt == torch.bfloat16 else "mma")
    f, s = fm.fused_mlp_train(p, torch.from_numpy(_points_of(case)),
                              torch.from_numpy(case["d"]), 15, 4, dt, exact,
                              dir_rep=S)
    g = torch.from_numpy(g)
    grads = torch.autograd.grad([f, s], fr.flatten_params(p),
                                [g[:, :C], g[:, C]])
    return [x.numpy() for x in grads]


@pytest.fixture(scope="module")
def cotangent():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(N * S, C + 1)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_per_point_backward_at_served_widths_matches_pallas_fp32(
        served, cotangent, exact):
    """fp32, both encodes: tests/test_torch_fused_mlp.py's bound for the
    plain backward against the Pallas VJP (1e-4 absolute, 1e-3
    relative)."""
    fn = make_fused_mlp_train(15, 4, tile=32, interpret=True, dir_rep=S,
                              compute_dtype=jnp.float32, exact_encode=exact)
    xyz, d = jnp.asarray(_points_of(served)), jnp.asarray(served["d"])
    _, vjp = jax.vjp(lambda p: fn(p, xyz, d), served["jp"])
    (g,) = vjp(jnp.asarray(cotangent))
    got = _port_grads(served, torch.float32, exact, cotangent)
    for i, (want, b) in enumerate(zip(jax.tree.leaves(tuple(g)), got)):
        want = np.asarray(want)
        assert want.shape == b.shape, i
        assert np.abs(want).max() > 0, i
        np.testing.assert_allclose(b, want, atol=1e-4, rtol=1e-3,
                                   err_msg=str(i))


@pytest.fixture(scope="module")
def served_bwd_bf16(served, cotangent, tmp_path_factory):
    """make_fused_mlp_train's VJP at bf16 with the recurrence encode on
    the served case, a direction a ray, in a process with XLA's excess
    precision off."""
    d = tmp_path_factory.mktemp("served_mlp_bwd")
    leaves = [np.asarray(x) for x in jax.tree.leaves(tuple(served["jp"]))]
    np.savez(d / "in.npz", xyz=_points_of(served), d=served["d"],
             g=cotangent, depth=DEPTH, s=S,
             **{f"p{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BF16, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = dict(np.load(d / "out.npz"))
    return [ref[f"g{i}"] for i in range(len(leaves))]


def test_per_point_backward_at_served_widths_matches_pallas_bf16(
        served, cotangent, served_bwd_bf16):
    """bf16, the recurrence: tests/test_torch_fused_mlp.py's bound for the
    plain backward against the Pallas VJP run with excess precision off,
    3e-2 of each tensor's largest gradient."""
    got = _port_grads(served, torch.bfloat16, False, cotangent)
    for i, (a, b) in enumerate(zip(served_bwd_bf16, got)):
        assert a.shape == b.shape, i
        assert np.abs(a - b).max() / np.abs(a).max() <= 3e-2, i
