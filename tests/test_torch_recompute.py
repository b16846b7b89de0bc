"""The no-stash training routes of the fused render
(crnerf_tpu_torch.ops.fused_render): the xyz-in plain forward and the plain
recompute backward against the JAX package's Pallas kernels in interpret
mode (fused_render_apply(rays_in=False) and
make_fused_render_train(stash=False) under jax.vjp, both rays_in forms), and
against the port's own stash route.

Rays-in inputs are quantized to 6 fractional bits, as in tests/test_ops.py,
so o + d*z is exact in f32 and both sides encode the same xyz. The xyz-in
inputs are those points plus a 1e-5 * U[0, 1) jitter, made once with numpy
and handed to both sides as the same float32 numbers, so the 2^14 octave
sees identical arguments. The cotangents are random and non-zero in every
column, the depth column and the weights included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.ops.fused_mlp import mlp_params_from_flax
from crnerf_tpu.ops.fused_render import (
    fused_render_apply,
    make_fused_render_train,
)
from crnerf_tpu_torch.ops import fused_render as fr

torch.set_num_threads(2)
C = 16
DEPTH = 6  # reaches the skip layer (index 4)
N, S = 16, 16


def _q(x):
    return np.round(x * 64.0) / 64.0


def _torch_params(jp, requires_grad=False):
    def leaf(a):
        return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)

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
    exact_xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    jitter = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    xyz = (exact_xyz + np.float32(1e-5) * jitter).astype(np.float32)
    g_ray = np.zeros((N, 128), np.float32)
    g_ray[:, :C + 1] = rng.normal(size=(N, C + 1)) * 0.1
    g_w = (rng.normal(size=(N, S)) * 0.1).astype(np.float32)
    mlp = FlaxNerfMLP(depth=DEPTH, width=64, out_dim=C)
    v = mlp.init(jax.random.PRNGKey(3), jnp.zeros((1, 93)),
                 jnp.zeros((1, 27)))
    jp = mlp_params_from_flax(v["params"], depth=DEPTH)
    return dict(o=o, d=d, z=z, noise=noise, xyz=xyz, exact_xyz=exact_xyz,
                g_ray=g_ray, g_w=g_w, jp=jp)


def _jax_grads(case, rays_in, compute_dtype, exact):
    fn = make_fused_render_train(
        15, 4, s=S, r_tile=8, interpret=True, rays_in=rays_in, stash=False,
        compute_dtype=compute_dtype, exact_encode=exact)
    a = lambda k: jnp.asarray(case[k])  # noqa: E731
    pos = a("o") if rays_in else a("xyz")
    out, vjp = jax.vjp(
        lambda p: fn(p, pos, a("d"), a("z"), a("noise")), case["jp"])
    (g,) = vjp((a("g_ray"), a("g_w")))
    return out, g


def _port_grads(case, rays_in, compute_dtype, exact, cot=None, **kw):
    """Through the autograd Function on CPU tensors: the plain forward
    and, with stash=False, the plain recompute backward."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"], requires_grad=True)
    kw.setdefault("stash", False)
    blk, w = fr.fused_render_train(
        p, t("o"), t("d"), t("z"), t("noise"), 15, 4, compute_dtype, exact,
        xyz=None if rays_in else t("xyz"), **kw)
    grads = torch.autograd.grad([blk, w], fr.flatten_params(p),
                                cot or [t("g_ray"), t("g_w")])
    return (blk, w), fr.unflatten_params(grads)


def _leaves(p):
    return [np.asarray(x) for x in jax.tree.leaves(tuple(p))]


def _flat(g):
    return [x.numpy() for x in fr.flatten_params(g)]


NAMES = ([f"trunk_w{i}" for i in range(DEPTH)]
         + [f"trunk_b{i}" for i in range(DEPTH)]
         + ["sigma_w", "sigma_b", "final_w", "final_b", "dir_w", "dir_b",
            "feat_w", "feat_b"])


@pytest.mark.parametrize("exact", [True, False])
def test_xyz_in_plain_forward_matches_pallas_stream_kernel_fp32(case, exact):
    """The xyz-in forward on jittered points against the JAX kernel's
    rays_in=False form: fp32, tests/test_ops.py's kernel-vs-twin tolerances
    (weights 1e-4, fmap 1e-4, depth 2e-4); the sides differ in summation
    order only."""
    a = lambda k: jnp.asarray(case[k])  # noqa: E731
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    blk_j, w_j = fused_render_apply(
        case["jp"], a("xyz"), a("d"), a("z"), a("noise"), r_tile=8,
        interpret=True, rays_in=False, exact_encode=exact)
    blk_t, w_t = fr.render_fwd_plain(
        _torch_params(case["jp"]), None, t("d"), t("z"), t("noise"),
        exact_encode=exact, xyz=t("xyz"))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-4)
    np.testing.assert_allclose(blk_t.numpy()[:, :C], np.asarray(blk_j)[:, :C],
                               atol=1e-4)
    np.testing.assert_allclose(blk_t.numpy()[:, C], np.asarray(blk_j)[:, C],
                               atol=2e-4)
    assert np.all(blk_t.numpy()[:, C + 1:] == 0)


def test_the_jitter_reaches_the_encode(case):
    """1e-5 in x is ~0.16 rad in the 2^14 octave: the jittered forward must
    differ visibly from the unjittered one, or the test above would pass
    with the jitter dropped."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"])
    blk_x, _ = fr.render_fwd_plain(p, None, t("d"), t("z"), t("noise"),
                                   xyz=t("xyz"))
    blk_r, _ = fr.render_fwd_plain(p, t("o"), t("d"), t("z"), t("noise"))
    assert float((blk_x - blk_r).abs().max()) > 1e-3


@pytest.mark.parametrize("stash", [False, True])
def test_xyz_in_without_jitter_equals_rays_in_bit_for_bit(case, stash):
    """The points o + d*z handed in as xyz give the rays-in result: same
    outputs, same stash (cf. tests/test_ops.py test_matches_stream_mode)."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"])
    xyz = t("o")[:, None] + t("d")[:, None] * t("z")[..., None]
    assert torch.equal(xyz, t("exact_xyz"))
    args = (15, 4, torch.bfloat16, False)
    a = fr.render_fwd_plain(p, t("o"), t("d"), t("z"), t("noise"), *args,
                            stash=stash)
    b = fr.render_fwd_plain(p, None, t("d"), t("z"), t("noise"), *args,
                            stash=stash, xyz=xyz)
    assert len(a) == len(b) == (3 if stash else 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rays_in", [True, False])
def test_plain_recompute_matches_pallas_recompute_kernel_fp32(case, rays_in,
                                                              exact):
    """fp32, both input forms: tests/test_ops.py's tolerance for the JAX
    kernel against its own twin (1e-4 absolute, 1e-3 relative), as
    tests/test_torch_train_kernels.py holds the stash pair."""
    (blk_j, w_j), g_j = _jax_grads(case, rays_in, jnp.float32, exact)
    (blk_t, w_t), g_t = _port_grads(case, rays_in, torch.float32, exact)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               atol=1e-4)
    np.testing.assert_allclose(blk_t.detach().numpy()[:, :C + 1],
                               np.asarray(blk_j)[:, :C + 1], atol=2e-4)
    for name, a, b in zip(NAMES, _leaves(g_j), _flat(g_t)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("rays_in", [True, False])
def test_plain_recompute_bf16_policy_matches_pallas_recompute_kernel(
        case, rays_in):
    """bf16, both input forms: both sides round every product operand to
    bf16 at the same points and differ where an fp32 sum lands on the other
    side of a rounding boundary. Per tensor, relative to its largest
    gradient: 3e-2, the bound of the stash pair's test, which the same
    gradients computed at fp32 exceed."""
    _, g_j = _jax_grads(case, rays_in, jnp.bfloat16, False)
    _, g_t = _port_grads(case, rays_in, torch.bfloat16, False)
    _, g_f = _port_grads(case, rays_in, torch.float32, False)
    worst_f32 = 0.0
    for name, a, b, f in zip(NAMES, _leaves(g_j), _flat(g_t), _flat(g_f)):
        scale = np.abs(a).max()
        assert np.abs(a - b).max() / scale <= 3e-2, name
        worst_f32 = max(worst_f32, np.abs(a - f).max() / scale)
    assert worst_f32 > 3e-2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rays_in", [True, False])
def test_recompute_equals_the_stash_route(case, rays_in, dt):
    """One slab holding every ray: the recomputed stash is the stash the
    forward would have kept, so outputs and gradients equal the stash
    route's bit for bit (the JAX package's
    test_stash_backward_bit_matches_recompute)."""
    exact = dt == torch.float32
    out_s, g_s = _port_grads(case, rays_in, dt, exact, stash=True)
    out_r, g_r = _port_grads(case, rays_in, dt, exact, stash=False,
                             slab_rays=N)
    for a, b in zip(out_s, out_r):
        assert torch.equal(a, b)
    for a, b in zip(fr.flatten_params(g_s), fr.flatten_params(g_r)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("slab_rays", [1, 5, N, 4 * N])
def test_slab_size_does_not_change_the_gradients(case, slab_rays):
    """Slabs of one ray, of a size that does not divide N, of N and of more
    than N: the same gradients up to the grouping of the fp32 sums over the
    points (1e-5 of each tensor's largest), and with one slab the same
    bits."""
    _, want = _port_grads(case, True, torch.float32, True, slab_rays=N)
    _, got = _port_grads(case, True, torch.float32, True,
                         slab_rays=slab_rays)
    for name, a, b in zip(NAMES, _flat(want), _flat(got)):
        if slab_rays >= N:
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), name


def test_slab_scratch_does_not_grow_with_the_batch(case):
    """slab_rays_for bounds the slab's stash + dz buffer by the budget,
    whatever N is; a small batch is one slab."""
    kw = fr.prepare_kernel_weights(_torch_params(case["jp"]), 15, 4,
                                   torch.bfloat16)
    lay = fr.grad_layout(kw.dims)
    per_ray = S * (lay.sc + lay.dc) * 2
    budget = 10 * per_ray + 7
    sizes = [fr.slab_rays_for(kw, n, S, budget=budget)
             for n in (4, 10, 11, 1000, 10 ** 6)]
    assert sizes == [4, 10, 10, 10, 10]
    assert fr.slab_rays_for(kw, 5, S, budget=1) == 1
    r = fr.slab_rays_for(kw, 16384, 128)
    assert r * 128 * (lay.sc + lay.dc) * 2 <= fr.RECOMPUTE_SCRATCH_BYTES
    assert r >= 256


@pytest.mark.parametrize("rays_in", [True, False])
def test_unused_cotangents_arrive_as_none_on_the_recompute_route(case,
                                                                 rays_in):
    """A loss that reads only the feature map: autograd hands the Function
    None for the weights' cotangent; the result equals explicit zeros."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    g_ray = t("g_ray").clone()
    g_ray[:, C] = 0
    xyz = None if rays_in else t("xyz")
    p = _torch_params(case["jp"], requires_grad=True)
    blk, _ = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"),
                                   xyz=xyz, stash=False)
    got = torch.autograd.grad((blk * g_ray).sum(), fr.flatten_params(p))
    _, want = _port_grads(case, rays_in, torch.float32, True,
                          cot=[g_ray, torch.zeros(N, S)])
    for a, b in zip(fr.flatten_params(want), got):
        assert torch.equal(a, b)


def test_recompute_route_keeps_no_stash_and_may_run_backward_twice(case):
    """Nothing but the inputs is saved for the backward, so it can run
    again on a retained graph (the stash route frees its stash and
    refuses)."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    p = _torch_params(case["jp"], requires_grad=True)
    blk, w = fr.fused_render_train(p, t("o"), t("d"), t("z"), t("noise"),
                                   stash=False)
    assert blk.grad_fn.stash is None
    saved = [x for x in blk.grad_fn.saved_tensors if x is not None]
    assert sum(x.numel() for x in saved) == N * (S + S + 3 + 3)
    flat = fr.flatten_params(p)
    loss = (blk * t("g_ray")).sum() + (w * t("g_w")).sum()
    g1 = torch.autograd.grad(loss, flat, retain_graph=True)
    g2 = torch.autograd.grad(loss, flat)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    p2 = _torch_params(case["jp"], requires_grad=True)
    blk2, w2 = fr.fused_render_train(p2, t("o"), t("d"), t("z"), t("noise"))
    assert blk2.grad_fn.stash is not None
    loss2 = (blk2 * t("g_ray")).sum() + (w2 * t("g_w")).sum()
    torch.autograd.grad(loss2, fr.flatten_params(p2), retain_graph=True)
    with pytest.raises(RuntimeError, match="stash was freed"):
        torch.autograd.grad(loss2, fr.flatten_params(p2))


def test_render_bwd_recompute_plain_takes_params_like_render_bwd_plain(case):
    """The params-level plain version (what a kernel check compares with)
    equals the Function's gradients."""
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    want = _port_grads(case, False, torch.float32, True, slab_rays=5)[1]
    got = fr.render_bwd_recompute_plain(
        _torch_params(case["jp"]), None, t("d"), t("z"), t("noise"),
        t("g_ray"), t("g_w"), xyz=t("xyz"), slab_rays=5)
    for a, b in zip(fr.flatten_params(want), fr.flatten_params(got)):
        assert torch.equal(a, b)


def test_cpu_recompute_launches_no_kernel(case):
    before = dict(fr.LAUNCH_COUNTS)
    _port_grads(case, True, torch.float32, True)
    _port_grads(case, False, torch.float32, True)
    assert fr.LAUNCH_COUNTS == before
    assert {"fused_render_fwd_xyz", "fused_render_bwd_recompute",
            "fused_render_bwd_recompute_xyz"} <= set(before)
