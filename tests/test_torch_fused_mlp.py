"""The per-point fused MLP (crnerf_tpu_torch.ops.fused_mlp): its plain
forward and its explicit plain backward against the JAX package's Pallas
kernels in interpret mode (fused_mlp_apply, and make_fused_mlp_train under
jax.vjp), from the same numpy-seeded inputs and weights.

Tolerances. fp32 forward: 2e-6, the JAX package's own bound for its kernel
against its twin (tests/test_ops.py TestFusedMlp), and 1e-5 with the
recurrence encode. fp32 backward: 1e-4
absolute + 1e-3 relative, as the fused render pairs (tests/test_ops.py's
kernel-vs-twin bound). bf16: the JAX side runs in a process of its own with
XLA's excess precision off (by default XLA on the CPU drops bf16 roundings
the written program has); forward mean 2e-5, between the measured 4.6e-6
and an fp32-computed MLP's 2.2e-4 (asserted > 1e-4), and max 2e-3;
backward 3e-2 of each leaf's largest gradient, which the fp32 gradients
exceed."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.ops.fused_mlp import (
    fused_mlp_apply,
    make_fused_mlp_train,
    mlp_params_from_flax,
)
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, S = 15, 5          # rays x samples: 75 points, no multiple of a tile
M = N * S
SHAPES = {"flagship": dict(depth=8, width=256, out_dim=64),
          "small": dict(depth=4, width=64, out_dim=16),
          "skip": dict(depth=6, width=64, out_dim=16)}


def _torch_params(jp, requires_grad=False):
    def leaf(a):
        return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)

    return fr.MlpParams(*[tuple(leaf(a) for a in f) if isinstance(f, tuple)
                          else leaf(f) for f in jp])


def _case(shape: str, seed: int = 0):
    kw = SHAPES[shape]
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(M, 3)).astype(np.float32)
    d = rng.normal(size=(M, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = kw["out_dim"]
    g = (rng.normal(size=(M, c + 1)) * 0.1).astype(np.float32)
    mlp = FlaxNerfMLP(**kw)
    v = mlp.init(jax.random.PRNGKey(seed + 3), jnp.zeros((1, 93)),
                 jnp.zeros((1, 27)))
    params = jax.tree.map(np.asarray, v["params"])
    # flax initialises biases to zero: give every bias a value
    for name, layer in params.items():
        layer["bias"] = rng.uniform(-0.3, 0.3, layer["bias"].shape).astype(
            np.float32)
    jp = mlp_params_from_flax(params, depth=kw["depth"])
    return dict(xyz=xyz, d=d, g=g, jp=jp, c=c, depth=kw["depth"])


@pytest.fixture(scope="module", params=list(SHAPES))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def skip_case():
    return _case("skip")


def _dirs(case, dir_rep):
    return case["d"][:M // dir_rep]


def _port_fwd(case, dir_rep, dt=torch.float32, exact=True):
    f, s = fm.mlp_apply_plain(
        _torch_params(case["jp"]), torch.from_numpy(case["xyz"]),
        torch.from_numpy(_dirs(case, dir_rep)), 15, 4, dt, exact,
        dir_rep=dir_rep)
    return torch.cat([f, s[:, None]], -1).numpy()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dir_rep", [1, S])
def test_plain_forward_matches_pallas_kernel_fp32(case, dir_rep, exact):
    """Ragged N (75 points on tiles of 32), the flagship shape, the small-
    width model and one that reaches the skip; a direction per point and
    one per ray."""
    want = fused_mlp_apply(
        case["jp"], jnp.asarray(case["xyz"]),
        jnp.asarray(_dirs(case, dir_rep)), tile=32, interpret=True,
        dir_rep=dir_rep, exact_encode=exact)
    got = _port_fwd(case, dir_rep, exact=exact)
    assert got.shape == want.shape == (M, case["c"] + 1)
    # the recurrence grows a one-ulp difference of an anchor's sin/cos
    # ~2.8x per octave (XLA may fuse its multiply-adds): 1e-5 there
    np.testing.assert_allclose(got, np.asarray(want),
                               atol=2e-6 if exact else 1e-5)
    assert got[:, -1].min() >= 0 and 0 <= got[:, :-1].min()
    assert got[:, :-1].max() <= 1


def test_dir_rep_equals_repeated_directions(skip_case):
    """One direction per ray gives what the same directions repeated per
    point give, bit for bit."""
    p = _torch_params(skip_case["jp"])
    xyz = torch.from_numpy(skip_case["xyz"])
    d = torch.from_numpy(_dirs(skip_case, S))
    a = fm.mlp_apply_plain(p, xyz, d, dir_rep=S)
    b = fm.mlp_apply_plain(p, xyz, d.repeat_interleave(S, 0), dir_rep=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="does not cover"):
        fm.mlp_apply_plain(p, xyz, d, dir_rep=S - 1)


def _jax_grads(case, dir_rep, compute_dtype, exact):
    fn = make_fused_mlp_train(15, 4, tile=32, interpret=True,
                              dir_rep=dir_rep, compute_dtype=compute_dtype,
                              exact_encode=exact)
    out, vjp = jax.vjp(
        lambda p: fn(p, jnp.asarray(case["xyz"]),
                     jnp.asarray(_dirs(case, dir_rep))), case["jp"])
    return out, vjp(jnp.asarray(case["g"]))[0]


def _port_grads(case, dir_rep, dt=torch.float32, exact=True, **kw):
    c = case["c"]
    return fm.mlp_bwd_plain(
        _torch_params(case["jp"]), torch.from_numpy(case["xyz"]),
        torch.from_numpy(_dirs(case, dir_rep)),
        torch.from_numpy(case["g"][:, :c].copy()),
        torch.from_numpy(case["g"][:, c].copy()), 15, 4, dt, exact,
        dir_rep=dir_rep, **kw)


def _names(depth):
    return ([f"trunk_w{i}" for i in range(depth)]
            + [f"trunk_b{i}" for i in range(depth)]
            + ["sigma_w", "sigma_b", "final_w", "final_b", "dir_w", "dir_b",
               "feat_w", "feat_b"])


def _leaves(p):
    return [np.asarray(x) for x in jax.tree.leaves(tuple(p))]


def _flat(g):
    return [x.numpy() for x in fr.flatten_params(g)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dir_rep", [1, S])
def test_plain_backward_matches_pallas_vjp_fp32(case, dir_rep, exact):
    _, g_j = _jax_grads(case, dir_rep, jnp.float32, exact)
    g_t = _port_grads(case, dir_rep, exact=exact)
    for name, a, b in zip(_names(case["depth"]), _leaves(g_j), _flat(g_t)):
        assert a.shape == b.shape, name
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3, err_msg=name)


def test_explicit_backward_equals_autograd_of_the_plain_forward(skip_case):
    """fp32, where no rounding separates them: the explicit backward
    against torch.autograd through mlp_apply_plain, 1e-5 of each leaf's
    largest (order of fp32 sums)."""
    c = skip_case["c"]
    p = _torch_params(skip_case["jp"], requires_grad=True)
    f, s = fm.mlp_apply_plain(p, torch.from_numpy(skip_case["xyz"]),
                              torch.from_numpy(_dirs(skip_case, S)),
                              dir_rep=S)
    g = torch.from_numpy(skip_case["g"])
    want = torch.autograd.grad([f, s], fr.flatten_params(p),
                               [g[:, :c], g[:, c]])
    got = _port_grads(skip_case, S)
    for name, a, b in zip(_names(skip_case["depth"]), want,
                          fr.flatten_params(got)):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from crnerf_tpu.ops.fused_mlp import (MlpParams, fused_mlp_apply,
                                      make_fused_mlp_train)
inp = dict(np.load(sys.argv[1]))
depth, s = int(inp["depth"]), int(inp["s"])
leaves = [jnp.asarray(inp[f"p{i}"]) for i in range(2 * depth + 8)]
jp = MlpParams(tuple(leaves[:depth]), tuple(leaves[depth:2 * depth]),
               *leaves[2 * depth:])
xyz, d = jnp.asarray(inp["xyz"]), jnp.asarray(inp["d"])
kw = dict(tile=32, interpret=True, dir_rep=s, compute_dtype=jnp.bfloat16,
          exact_encode=False)
out = fused_mlp_apply(jp, xyz, d, **kw)
fn = make_fused_mlp_train(15, 4, **kw)
_, vjp = jax.vjp(lambda p: fn(p, xyz, d), jp)
g = jax.tree.leaves(tuple(vjp(jnp.asarray(inp["g"]))[0]))
np.savez(sys.argv[2], out=np.asarray(out),
         **{f"g{i}": np.asarray(a) for i, a in enumerate(g)})
"""


@pytest.fixture(scope="module")
def bf16_ref(tmp_path_factory, skip_case):
    """The JAX kernels at bf16 with the recurrence encode, one direction
    per ray, in a process with XLA's excess precision off."""
    d = tmp_path_factory.mktemp("mlp_bf16")
    leaves = _leaves(skip_case["jp"])
    np.savez(d / "in.npz", xyz=skip_case["xyz"], d=_dirs(skip_case, S),
             g=skip_case["g"], depth=skip_case["depth"], s=S,
             **{f"p{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BF16, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def test_plain_forward_bf16_policy_matches_pallas_kernel(skip_case, bf16_ref):
    """Both sides round to bf16 at the same points (the encode as it is
    made, every product operand, ReLU outputs, hf, dd) and keep the sigma
    head in fp32; a few values differ where an fp32 sum lands on the other
    side of a rounding boundary. Measured: mean 4.6e-6, max 5.7e-4; the
    same MLP computed at fp32: mean 2.2e-4, max 1.4e-3. The mean bound
    separates the two; the max bound is a ceiling."""
    want = bf16_ref["out"]
    got = np.abs(_port_fwd(skip_case, S, torch.bfloat16, exact=False) - want)
    f32 = np.abs(_port_fwd(skip_case, S, torch.float32, exact=False) - want)
    assert got.mean() <= 2e-5 and got.max() <= 2e-3, (got.mean(), got.max())
    assert f32.mean() > 1e-4


def test_sigma_head_is_fp32_on_unrounded_weights(skip_case, bf16_ref):
    """The policy that separates this pair from the fused render kernels:
    with the sigma weights rounded to bf16 (the fused render's sigma head)
    sigma moves away from the JAX kernel's. Measured mean error of sigma:
    9.5e-6 with the fp32 head, 2.2e-4 with rounded weights."""
    c = skip_case["c"]
    p = _torch_params(skip_case["jp"])
    xyz = torch.from_numpy(skip_case["xyz"])
    d = torch.from_numpy(_dirs(skip_case, S))
    args = (15, 4, torch.bfloat16, False)
    _, s_own = fm.mlp_apply_plain(p, xyz, d, *args, dir_rep=S)
    _, s_rounded = fm.mlp_apply_plain(
        p._replace(sigma_w=p.sigma_w.bfloat16().float()), xyz, d, *args,
        dir_rep=S)
    want = bf16_ref["out"][:, c]
    assert np.abs(s_own.numpy() - want).mean() <= 5e-5
    assert np.abs(s_rounded.numpy() - want).mean() > 1e-4


def test_plain_backward_bf16_policy_matches_pallas_vjp(skip_case, bf16_ref):
    g_t = _port_grads(skip_case, S, torch.bfloat16, exact=False)
    g_f = _port_grads(skip_case, S, torch.float32, exact=False)
    worst_f32 = 0.0
    names = _names(skip_case["depth"])
    for i, (name, b, f) in enumerate(zip(names, _flat(g_t), _flat(g_f))):
        a = bf16_ref[f"g{i}"]
        scale = np.abs(a).max()
        assert np.abs(a - b).max() / scale <= 3e-2, name
        worst_f32 = max(worst_f32, np.abs(a - f).max() / scale)
    assert worst_f32 > 3e-2


@pytest.mark.parametrize("slab_points", [1, 5, M, 4 * M])
def test_slab_size_does_not_change_the_gradients(skip_case, slab_points):
    """Slabs of one point, of a size that divides neither M nor a ray, of M
    and of more than M: the same gradients up to the grouping of the fp32
    sums over the points (1e-5 of each tensor's largest), and with one slab
    the same bits."""
    want = _port_grads(skip_case, S, slab_points=M)
    got = _port_grads(skip_case, S, slab_points=slab_points)
    for name, a, b in zip(_names(skip_case["depth"]), _flat(want),
                          _flat(got)):
        if slab_points >= M:
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), name


def test_slab_scratch_does_not_grow_with_the_batch(skip_case):
    mkw = fm.prepare_mlp_weights(_torch_params(skip_case["jp"]), 15, 4,
                                 torch.bfloat16)
    lay = fm.mlp_grad_layout(mkw.kw.dims)
    per_point = (lay.sc + lay.dc) * 2
    budget = 10 * per_point + 7
    sizes = [fm.slab_points_for(mkw, m, budget=budget)
             for m in (4, 10, 11, 1000, 10 ** 6)]
    assert sizes == [4, 10, 10, 10, 10]
    assert fm.slab_points_for(mkw, 5, budget=1) == 1
    # the stash is the fused render's plus the dir-encode columns, and the
    # dir-encode gradient is a job of the weight-gradient kernel
    base = fr.grad_layout(mkw.kw.dims)
    assert (lay.sc, lay.dc) == (base.sc + 32, base.dc)
    keys = [j[0] for j in lay.jobs]
    assert "wde" in keys and "ws" not in keys


def _train(case, p, dir_rep=S, **kw):
    return fm.fused_mlp_train(p, torch.from_numpy(case["xyz"]),
                              torch.from_numpy(_dirs(case, dir_rep)),
                              dir_rep=dir_rep, **kw)


def test_autograd_function_returns_the_explicit_gradients(skip_case):
    c = skip_case["c"]
    p = _torch_params(skip_case["jp"], requires_grad=True)
    f, s = _train(skip_case, p)
    g = torch.from_numpy(skip_case["g"])
    got = torch.autograd.grad([f, s], fr.flatten_params(p),
                              [g[:, :c], g[:, c]])
    for a, b in zip(fr.flatten_params(_port_grads(skip_case, S)), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("unused", ["sigma", "features"])
def test_unused_cotangents_arrive_as_none(skip_case, unused):
    """A loss that reads only one of the two outputs: autograd hands the
    Function None for the other's cotangent; the result equals explicit
    zeros there."""
    c = skip_case["c"]
    g = torch.from_numpy(skip_case["g"])
    p = _torch_params(skip_case["jp"], requires_grad=True)
    f, s = _train(skip_case, p)
    loss = ((f * g[:, :c]).sum() if unused == "sigma"
            else (s * g[:, c]).sum())
    got = torch.autograd.grad(loss, fr.flatten_params(p))
    zeroed = dict(skip_case, g=skip_case["g"].copy())
    if unused == "sigma":
        zeroed["g"][:, c] = 0
    else:
        zeroed["g"][:, :c] = 0
    for a, b in zip(fr.flatten_params(_port_grads(zeroed, S)), got):
        assert torch.equal(a, b)


def test_zero_cotangents_give_zero_gradients(skip_case):
    zeroed = dict(skip_case, g=np.zeros_like(skip_case["g"]))
    for g in _flat(_port_grads(zeroed, S)):
        assert not g.any()


def test_no_input_gradients_and_nothing_kept_but_the_inputs(skip_case):
    """Points and directions get no gradient (the JAX VJP returns zeros
    for them); the forward saves its inputs only, so the backward may run
    twice."""
    p = _torch_params(skip_case["jp"], requires_grad=True)
    xyz = torch.from_numpy(skip_case["xyz"]).requires_grad_(True)
    d = torch.from_numpy(_dirs(skip_case, S)).requires_grad_(True)
    f, s = fm.fused_mlp_train(p, xyz, d, dir_rep=S)
    flat = fr.flatten_params(p)
    loss = f.sum() + s.sum()
    gx, gd = torch.autograd.grad(loss, [xyz, d], allow_unused=True,
                                 retain_graph=True)
    assert gx is None and gd is None
    saved = [x for x in f.grad_fn.saved_tensors if x is not None]
    assert sum(x.numel() for x in saved) == M * 3 + N * 3
    g1 = torch.autograd.grad(loss, flat, retain_graph=True)
    g2 = torch.autograd.grad(loss, flat)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_cpu_tensors_launch_no_kernel(skip_case):
    before = dict(fm.LAUNCH_COUNTS)
    p = _torch_params(skip_case["jp"], requires_grad=True)
    f, s = _train(skip_case, p)
    (f.sum() + s.sum()).backward()
    mkw = fm.prepare_mlp_weights(_torch_params(skip_case["jp"]))
    fm.fused_mlp_apply(mkw, torch.from_numpy(skip_case["xyz"]),
                       torch.from_numpy(_dirs(skip_case, S)), dir_rep=S)
    assert fm.LAUNCH_COUNTS == before == {"fused_mlp_fwd": 0,
                                          "fused_mlp_fwd_mma": 0,
                                          "fused_mlp_bwd": 0,
                                          "fused_mlp_bwd_mma": 0}
