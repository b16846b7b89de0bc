"""The host side of the per-point forward's wgmma kernel and of the
recompute backward's two variants (crnerf_tpu_torch/ops/fused_mlp.py,
ops/fused_render.py) on the CPU: the fused MLP's wgmma weight stream, its
dir-encode slice included, unpacks to the padded matrices bit for bit;
each variant is chosen by dtype and width (the recompute's also by depth
and samples); both forward variants give the plain version on CPU tensors
and launch nothing; the forward of training asks for the backward's
variant and packs no stream; the wgmma recompute's slab is a whole number of
waves; and, at the served widths (WP 256, HP 128, CP 64, depth 3), the
per-point forward against the JAX package's fused_mlp_apply and the
no-stash pair (forward and recompute backward) against
make_fused_render_train(stash=False), both Pallas kernels in interpret
mode, with the bounds the existing tests hold those pairs to."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.ops.fused_mlp import fused_mlp_apply as jax_fused_mlp_apply
from crnerf_tpu.ops.fused_render import make_fused_render_train
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr
from test_torch_wgmma_render import _params, _rays, _unpack
from test_torch_wgmma_train import C, DEPTH, N, S, served  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _mlp_stream_matrices(mkw):
    """The fused MLP's stream cut back into its (K, N) matrices, in its
    order, beside what each must be at bf16: the padded matrix, its K
    padded with zero rows to the slices the kernel reads."""
    d, pad = mkw.kw.dims, mkw.kw.padded
    r = lambda m: m.to(torch.bfloat16).float()   # noqa: E731
    want = []
    for i in range(d["L"]):
        if ("wenc", i) in pad:
            want.append((("wenc", i), fr.WGMMA_KE, r(pad["wenc", i])))
        if ("wh", i) in pad:
            want.append((("wh", i), d["WP"], r(pad["wh", i])))
    want += [("wf", d["WP"], r(pad["wf"])), ("wdh", d["WP"], r(pad["wdh"])),
             ("wde", fr.WGMMA_DIR_K, r(pad["wde"])),
             ("wc", d["HP"], r(pad["wc"]))]
    stream = fm.wgmma_mlp_weights(mkw)
    off, out = 0, []
    for key, k, m in want:
        n = m.shape[1]
        out.append((key, _unpack(stream[off:off + k * n], k, n), m))
        off += k * n
    assert off == stream.numel()
    return out


@pytest.mark.parametrize("depth,width,c,dims", [
    (8, 256, 64, dict(WP=256, HP=128, CP=64, DK=27)),
    (5, 240, 40, dict(WP=256, HP=128, CP=64, DK=27)),   # ragged widths
])
def test_mlp_stream_unpacks_to_the_padded_matrices(depth, width, c, dims):
    """Every slice of the wgmma forward's stream, the dir-encode rows as
    one more 64-deep slice of the dir layer, is the padded matrix at bf16
    and zero past its rows; packed once, at its first use, beside the
    fused render's streams of the same layout."""
    mkw = fm.prepare_mlp_weights(_params(depth, width, c), 15, 4,
                                 torch.bfloat16)
    assert {k: mkw.kw.dims[k] for k in dims} == dims
    assert mkw.kw.derived == {}     # nothing is packed before its first use
    stream = fm.wgmma_mlp_weights(mkw)
    assert stream.dtype == torch.bfloat16
    assert fm.wgmma_mlp_weights(mkw) is stream          # packed once
    assert set(mkw.kw.derived) == {"flat", "wgmma_mlp"}
    for key, got, want in _mlp_stream_matrices(mkw):
        assert torch.equal(got[:want.shape[0]], want), key
        assert not got[want.shape[0]:].any(), key
    # the dir-encode rows are the layout's, rounded once to the compute
    # dtype; the fused render's forward stream is unchanged beside it
    wde = dict((k, g) for k, g, _ in _mlp_stream_matrices(mkw))["wde"]
    half = mkw.kw.params.dir_w.shape[1]
    assert torch.equal(wde[:27, :half], mkw.kw.params.dir_w[width:].to(
        torch.bfloat16).float())
    assert not wde[:, half:].any()


@pytest.mark.parametrize("depth,width,c,dt,n_dir,want", [
    (8, 256, 64, torch.bfloat16, 4, "wgmma"),    # the served MLPs
    (3, 240, 40, torch.bfloat16, 4, "wgmma"),    # pads to 256 / 128 / 64
    (8, 256, 64, torch.float32, 4, "mma"),       # no IEEE fp32 wgmma
    (8, 256, 128, torch.bfloat16, 4, "mma"),     # CP 128
    (3, 128, 64, torch.bfloat16, 4, "mma"),      # WP 128
    (6, 64, 16, torch.bfloat16, 4, "mma"),       # WP 64
    (4, 192, 64, torch.bfloat16, 4, "mma"),      # WP 192
    (4, 256, 64, torch.bfloat16, 10, "wgmma"),   # DK 63: one slice
    (4, 256, 64, torch.bfloat16, 11, "mma"),     # DK 69: two
])
def test_mlp_variant_by_dtype_and_width(depth, width, c, dt, n_dir, want):
    torch.manual_seed(0)
    p = fr.mlp_params_from_module(NerfMLP(
        depth=depth, width=width, out_dim=c, in_channels_dir=3 + 6 * n_dir))
    mkw = fm.prepare_mlp_weights(p, 15, n_dir, dt)
    assert fm.mlp_variant(mkw.kw.dims) == want
    assert mkw.kw.derived == {}     # the choice packs nothing


def _points(n, s, seed=2):
    o, d, z, _ = _rays(n, s, seed)
    return (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3), d


def test_both_mlp_variants_give_the_plain_version_on_cpu():
    """Named or by shape, the forward on CPU tensors is the plain version
    and launches nothing; from ``p_base`` on it is the same points' rows
    of the whole run's."""
    mkw = fm.prepare_mlp_weights(_params(3, 256, 64), 15, 4, torch.bfloat16)
    xyz, d = _points(5, 70)
    before = dict(fm.LAUNCH_COUNTS)
    want = fm.mlp_fwd_plain(mkw, xyz, d, False, 70)
    for variant in ("wgmma", "mma", None):
        f, s = fm.mlp_fwd(mkw, xyz, d, False, 70, variant=variant)
        assert torch.equal(f, want[0]) and torch.equal(s, want[1])
    f, s = fm.fused_mlp_apply(mkw, xyz, d, False, 70)
    assert torch.equal(f, want[0]) and torch.equal(s, want[1])
    for p_base in (1, 69, 71, 200):
        f, s = fm.mlp_fwd(mkw, xyz[p_base:], d, False, 70, p_base=p_base)
        assert torch.equal(f, want[0][p_base:])
        assert torch.equal(s, want[1][p_base:])
    assert fm.LAUNCH_COUNTS == before
    assert set(before) == {"fused_mlp_fwd", "fused_mlp_fwd_mma",
                           "fused_mlp_bwd", "fused_mlp_bwd_mma"}
    assert mkw.kw.derived == {}     # the plain version needs no stream
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fm.mlp_fwd(mkw, xyz, d, False, 70, variant="tma")
    with pytest.raises(ValueError, match="does not cover"):
        fm.mlp_fwd(mkw, xyz[1:], d, False, 70, p_base=2)
    mkw32 = fm.prepare_mlp_weights(_params(3, 256, 64), 15, 4, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fm.mlp_fwd(mkw32, xyz, d, False, 70, variant="wgmma")


@pytest.mark.parametrize("dt,want", [(torch.bfloat16, "wgmma"),
                                      (torch.float32, "mma")])
def test_mlp_training_forward_asks_for_the_backward_variant(monkeypatch, dt,
                                                            want):
    """fused_mlp_train's forward names the kernel whose stash form its
    backward recomputes (mlp_bwd_variant): at the served widths the wgmma
    one at bf16 and the mma.sync one at fp32; on CPU tensors nothing packs
    a wgmma stream."""
    seen = []
    real = fm.mlp_fwd

    def spy(mkw, *args, **kwargs):
        seen.append((mkw, kwargs.get("variant"),
                     fm.mlp_bwd_variant(mkw.kw.dims)))
        return real(mkw, *args, **kwargs)

    monkeypatch.setattr(fm, "mlp_fwd", spy)
    torch.manual_seed(1)
    m = NerfMLP(depth=3, width=256, out_dim=64)
    xyz, d = _points(4, 16)
    f, s = fm.fused_mlp_train(fr.mlp_params_from_module(m, detach=False),
                              xyz, d, compute_dtype=dt,
                              exact_encode=False, dir_rep=16)
    (f.sum() + s.sum()).backward()
    assert [(v, r) for _, v, r in seen] == [(want, want)]
    assert seen[0][0].kw.derived == {}
    assert m.trunk(0).weight.grad is not None


@pytest.mark.parametrize("depth,width,c,dt,s,want", [
    (8, 256, 64, torch.bfloat16, 64, "wgmma"),     # the step's two passes
    (8, 256, 64, torch.bfloat16, 128, "wgmma"),
    (3, 240, 40, torch.bfloat16, 256, "wgmma"),    # the chain's longest ray
    (3, 240, 40, torch.bfloat16, 257, "mma"),      # beyond it
    (9, 256, 64, torch.bfloat16, 128, "mma"),      # the chain's bias sums
    (8, 256, 64, torch.float32, 128, "mma"),       # no IEEE fp32 wgmma
    (8, 256, 128, torch.bfloat16, 128, "mma"),     # CP 128
    (3, 128, 64, torch.bfloat16, 128, "mma"),      # WP 128
])
def test_recompute_variant_by_shape(depth, width, c, dt, s, want):
    """The recompute backward, and so the no-stash training forward, take
    wgmma where both the wgmma forward and the wgmma chain take the shape:
    else the mma.sync triple, forward included."""
    kw = fr.prepare_kernel_weights(_params(depth, width, c), 15, 4, dt)
    assert fr.recompute_variant(kw.dims, s) == want
    if want == "wgmma":
        assert fr.render_variant(kw.dims) == "wgmma"
    assert kw.derived == {}


@pytest.mark.parametrize("n_sm", [132, 114, 7])
@pytest.mark.parametrize("s", [64, 128, 100, 256])
def test_wgmma_slab_is_whole_waves_and_even(monkeypatch, n_sm, s):
    """On a card the wgmma recompute's slab is a whole number of its
    kernels' waves of items (n_sm rays, or n_sm pairs of rays at s <= 64)
    and an even number of rays (two waves a step when a wave is odd), for
    any budget that holds such a step; below it an even number; and the
    whole batch when it fits."""
    monkeypatch.setattr(fr, "_sm_count", lambda dev: n_sm)
    kw = fr.prepare_kernel_weights(_params(8, 256, 64), 15, 4,
                                   torch.bfloat16)
    assert fr.recompute_variant(kw.dims, s) == "wgmma"
    lay = fr.grad_layout(kw.dims)
    per_ray = s * (lay.sc + lay.dc) * 2
    wave = n_sm * (2 if s <= 64 else 1)
    step = wave if wave % 2 == 0 else 2 * wave
    for budget_rays in (step, 3 * step + 5, 13 * step - 1):
        r = fr.slab_rays_for(kw, 10 ** 6, s, "cuda", per_ray * budget_rays)
        assert r % wave == 0 and r % 2 == 0 and 0 < r <= budget_rays
        assert budget_rays - r < step
    for budget_rays in (step - 1, 3):
        r = fr.slab_rays_for(kw, 10 ** 6, s, "cuda", per_ray * budget_rays)
        assert r % 2 == 0 and 0 < r <= budget_rays and budget_rays - r < 2
    assert fr.slab_rays_for(kw, 5, s, "cuda", per_ray * step) == 5
    # the mma.sync triple keeps its own rule: whole grids of its chain
    r = fr.slab_rays_for(kw, 10 ** 6, s, "cuda", per_ray * (3 * step + 5),
                         variant="mma")
    assert r % fr._chain_grid(kw, r, "cuda")[0] == 0


def test_recompute_refuses_a_variant_the_shape_does_not_take():
    o, d, z, noise = _rays(3, 8)
    g_ray, g_w = torch.zeros(3, 128), torch.zeros(3, 8)
    kw32 = fr.prepare_kernel_weights(_params(3, 256, 64), 15, 4,
                                     torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fr.bwd_recompute(kw32, o, d, z, noise, g_ray, g_w, variant="wgmma")
    kw = fr.prepare_kernel_weights(_params(3, 256, 64), 15, 4,
                                   torch.bfloat16)
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w, variant="tma")
    # on CPU tensors both variants are the plain version
    before = dict(fr.LAUNCH_COUNTS)
    a = fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w, variant="wgmma")
    b = fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w, variant="mma")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fr.LAUNCH_COUNTS == before
    assert {"fused_render_bwd_recompute_mma",
            "fused_render_bwd_recompute_xyz_mma"} <= set(before)
    assert kw.derived == {}


# ------------------------------------------- the served widths vs Pallas
def _port_params(jp, requires_grad=False):
    return fr.MlpParams(*[
        tuple(torch.from_numpy(np.array(a)).requires_grad_(requires_grad)
              for a in f) if isinstance(f, tuple)
        else torch.from_numpy(np.array(f)).requires_grad_(requires_grad)
        for f in jp])


def _points_of(case):
    """The rays' sample points, a direction a ray."""
    return (case["o"][:, None, :] + case["d"][:, None, :]
            * case["z"][..., None]).reshape(-1, 3).astype(np.float32)


def _port_mlp(case, dt, exact):
    mkw = fm.prepare_mlp_weights(_port_params(case["jp"]), 15, 4, dt)
    assert fm.mlp_variant(mkw.kw.dims) == (
        "wgmma" if dt == torch.bfloat16 else "mma")
    f, s = fm.fused_mlp_apply(mkw, torch.from_numpy(_points_of(case)),
                              torch.from_numpy(case["d"]), exact, S)
    return torch.cat([f, s[:, None]], -1).numpy()


def test_per_point_forward_at_served_widths_matches_pallas_fp32(served):
    """fp32: tests/test_torch_fused_mlp.py's bounds for the plain forward
    against the Pallas kernel (2e-6 exact, 1e-5 with the recurrence)."""
    for exact, tol in ((True, 2e-6), (False, 1e-5)):
        want = jax_fused_mlp_apply(
            served["jp"], jnp.asarray(_points_of(served)),
            jnp.asarray(served["d"]), tile=32, interpret=True, dir_rep=S,
            exact_encode=exact)
        got = _port_mlp(served, torch.float32, exact)
        assert got.shape == want.shape == (N * S, C + 1)
        np.testing.assert_allclose(got, np.asarray(want), atol=tol)


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from crnerf_tpu.ops.fused_mlp import MlpParams, fused_mlp_apply
from crnerf_tpu.ops.fused_render import make_fused_render_train
inp = dict(np.load(sys.argv[1]))
depth, s = int(inp["depth"]), int(inp["s"])
leaves = [jnp.asarray(inp[f"p{i}"]) for i in range(2 * depth + 8)]
jp = MlpParams(tuple(leaves[:depth]), tuple(leaves[depth:2 * depth]),
               *leaves[2 * depth:])
a = lambda k: jnp.asarray(inp[k])
out = fused_mlp_apply(jp, a("xyz"), a("d"), tile=32, interpret=True,
                      dir_rep=s, compute_dtype=jnp.bfloat16,
                      exact_encode=False)
res = {"mlp": np.asarray(out)}
for rays_in in (True, False):
    fn = make_fused_render_train(15, 4, s=s, r_tile=8, interpret=True,
                                 rays_in=rays_in, stash=False,
                                 compute_dtype=jnp.bfloat16,
                                 exact_encode=False)
    pos = a("o") if rays_in else a("xyz3")
    _, vjp = jax.vjp(lambda p: fn(p, pos, a("d"), a("z"), a("noise")), jp)
    g = jax.tree.leaves(tuple(vjp((a("g_ray"), a("g_w")))[0]))
    res.update({f"g{int(rays_in)}_{i}": np.asarray(x)
                for i, x in enumerate(g)})
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module")
def served_bf16(served, tmp_path_factory):
    """The JAX kernels at bf16 with the recurrence encode on the served
    case, in a process with XLA's excess precision off (XLA on the CPU
    otherwise drops bf16 roundings the written program has): the per-point
    forward and the no-stash pair's gradients in both input forms."""
    d = tmp_path_factory.mktemp("served_bf16")
    leaves = [np.asarray(x) for x in jax.tree.leaves(tuple(served["jp"]))]
    np.savez(d / "in.npz", depth=DEPTH, s=S, xyz=_points_of(served),
             xyz3=_points_of(served).reshape(N, S, 3),
             **{k: served[k] for k in ("o", "d", "z", "noise", "g_ray",
                                       "g_w")},
             **{f"p{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BF16, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(d / "out.npz")), len(leaves)


def test_per_point_forward_at_served_widths_matches_pallas_bf16(
        served, served_bf16):
    """bf16, the recurrence: tests/test_torch_fused_mlp.py's bounds for the
    plain forward against the Pallas kernel (mean 2e-5, max 2e-3), which
    the same MLP computed at fp32 misses on the mean (> 1e-4)."""
    ref, _ = served_bf16
    got = np.abs(_port_mlp(served, torch.bfloat16, False) - ref["mlp"])
    f32 = np.abs(_port_mlp(served, torch.float32, False) - ref["mlp"])
    assert got.mean() <= 2e-5 and got.max() <= 2e-3, (got.mean(), got.max())
    assert f32.mean() > 1e-4


def _port_recompute(case, rays_in, dt, exact):
    """Through the autograd Function on CPU tensors with stash=False: the
    plain forward and the plain recompute backward, at the recompute's
    variant (checked: wgmma at bf16)."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _port_params(case["jp"], requires_grad=True)
    kw = fr.prepare_kernel_weights(p, 15, 4, dt)
    assert fr.recompute_variant(kw.dims, S) == (
        "wgmma" if dt == torch.bfloat16 else "mma")
    xyz = None if rays_in else torch.from_numpy(
        _points_of(case).reshape(N, S, 3))
    blk, w = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"),
                                   15, 4, dt, exact, xyz=xyz, stash=False)
    assert blk.grad_fn.stash is None
    grads = torch.autograd.grad([blk, w], fr.flatten_params(p),
                                [t("g_ray"), t("g_w")])
    return (blk, w), [x.numpy() for x in grads]


@pytest.mark.parametrize("rays_in", [True, False])
def test_recompute_pair_at_served_widths_matches_pallas_fp32(served,
                                                             rays_in):
    """fp32, exact encode, both input forms: tests/test_ops.py's tolerance
    for the JAX kernel against its own twin (1e-4 absolute, 1e-3
    relative), as the no-stash pair is held at 6 x 64."""
    fn = make_fused_render_train(15, 4, s=S, r_tile=8, interpret=True,
                                 rays_in=rays_in, stash=False,
                                 compute_dtype=jnp.float32, exact_encode=True)
    a = lambda k: jnp.asarray(served[k])  # noqa: E731
    pos = a("o") if rays_in else jnp.asarray(
        _points_of(served).reshape(N, S, 3))
    (blk_j, w_j), vjp = jax.vjp(
        lambda p: fn(p, pos, a("d"), a("z"), a("noise")), served["jp"])
    (g,) = vjp((a("g_ray"), a("g_w")))
    (blk_t, w_t), g_t = _port_recompute(served, rays_in, torch.float32,
                                        True)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               atol=1e-4)
    np.testing.assert_allclose(blk_t.detach().numpy()[:, :C + 1],
                               np.asarray(blk_j)[:, :C + 1], atol=2e-4)
    for i, (want, got) in enumerate(zip(jax.tree.leaves(tuple(g)), g_t)):
        want = np.asarray(want)
        assert want.shape == got.shape, i
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3,
                                   err_msg=str(i))


@pytest.mark.parametrize("rays_in", [True, False])
def test_recompute_pair_at_served_widths_matches_pallas_bf16(
        served, served_bf16, rays_in):
    """bf16, the recurrence, both input forms, against the JAX no-stash
    pair run with excess precision off: the bound the stash pair at these
    widths is held to (6e-2 of each tensor's largest gradient, see
    tests/test_torch_wgmma_train.py), which the fp32 gradients exceed."""
    ref, n_leaves = served_bf16
    g_j = [ref[f"g{int(rays_in)}_{i}"] for i in range(n_leaves)]
    _, g_t = _port_recompute(served, rays_in, torch.bfloat16, False)
    _, g_f = _port_recompute(served, rays_in, torch.float32, False)
    worst_f32 = 0.0
    for i, (a, b, f) in enumerate(zip(g_j, g_t, g_f)):
        assert a.shape == b.shape, i
        scale = np.abs(a).max()
        assert np.abs(a - b).max() / scale <= 6e-2, i
        worst_f32 = max(worst_f32, np.abs(a - f).max() / scale)
    assert worst_f32 > 6e-2, worst_f32
