"""The port's CUDA kernels on the card, against their plain PyTorch
versions, at small shapes. Skipped without a CUDA device. The card has no jax, and
tests/conftest.py imports it, so run these there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_render as fr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, n, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g) * 0.5
    d = torch.randn(n, 3, generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.sort(torch.rand(n, s, generator=g) * 4 + 0.5, -1).values
    noise = torch.randn(n, s, generator=g)
    return [t.to(dev) for t in (o, d, z, noise)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", [
    (6, 64, 16, 8), (6, 64, 16, 100), (8, 256, 64, 64), (2, 48, 24, 130),
])
def test_kernel_matches_plain(dev, dt, exact, depth, width, c, s):
    """S not a multiple of 64 exercises the partial last chunk; width 48
    and C 24 the zero padding to the kernel's 32-granules. The launch
    counts under the variant render_variant chose (8x256 at bf16: wgmma;
    the rest: mma.sync)."""
    torch.manual_seed(1)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, noise = _inputs(dev, 37, s)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    key = ("fused_render_fwd" if fr.render_variant(kw.dims) == "wgmma"
           else "fused_render_fwd_mma")
    before = dict(fr.LAUNCH_COUNTS)
    blk_k, w_k = fr.fused_render_apply(kw, o, d, z, noise, exact)
    blk_p, w_p = fr.render_fwd_plain(params, o, d, z, noise,
                                     compute_dtype=dt, exact_encode=exact)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(before, **{key: before[key] + 1})
    tw, tf, td = fr.KERNEL_TOL[dt]
    assert float((w_k - w_p).abs().max()) <= tw
    assert float((blk_k[:, :c] - blk_p[:, :c]).abs().max()) <= tf
    assert float((blk_k[:, c] - blk_p[:, c]).abs().max()) <= td
    assert torch.all(blk_k[:, c + 1:] == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    torch.manual_seed(2)
    kw = fr.prepare_kernel_weights(fr.mlp_params_from_module(
        NerfMLP(depth=4, width=32, out_dim=16).to(dev)))
    o, d, z, noise = _inputs(dev, 8, 16)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render_apply(kw, o, d, z.double(), noise)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_render_apply(kw, o, d, z.T.contiguous().T, noise)
    with pytest.raises(ValueError, match="on cpu"):
        fr.fused_render_apply(kw, o.cpu(), d, z, noise)


def test_renderer_on_card_matches_cpu(dev):
    """The whole slice at a small fp32 config: the card (kernel, cuDNN)
    against the CPU (plain versions); rgb in [0, 1]."""
    from crnerf_tpu_torch.config import Config
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(N_samples=16, N_importance=16, netdepth=6, netwidth=64,
                 nerf_out_dim=16, appearance_wh=(64, 48), chunk=256,
                 N_emb_xyz=10)
    torch.manual_seed(3)
    cpu_sys = CrNerfSystem(cfg).eval()
    card_sys = CrNerfSystem(cfg).eval()
    card_sys.load_state_dict(cpu_sys.state_dict())
    card_sys.to(dev)
    style = np.random.default_rng(0).uniform(-1, 1, (1, 48, 64, 3)).astype(
        np.float32)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5]], np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    out = {}
    for name, system in (("cpu", cpu_sys), ("card", card_sys)):
        r = Renderer(cfg, system)
        out[name] = r.fetch(r.render_frame_cam_async(c2w, K, 0.5, 2.5,
                                                     (24, 32), style))
    for k in ("rgb", "depth", "mask"):
        assert np.isfinite(out["card"][k]).all()
    np.testing.assert_allclose(out["card"]["rgb"], out["cpu"]["rgb"],
                               atol=1e-3)
    np.testing.assert_allclose(out["card"]["mask"], out["cpu"]["mask"],
                               atol=1e-4)


def _train_case(dev, dt, exact, depth, width, c, s, n=37, seed=1):
    torch.manual_seed(seed)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, noise = _inputs(dev, n, s)
    g = torch.Generator().manual_seed(seed + 7)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    ldo = fr._round_up(c + 1, fr.LANE)
    g_ray = torch.zeros(n, ldo)
    g_ray[:, :c + 1] = torch.randn(n, c + 1, generator=g) * 0.1
    g_w = torch.randn(n, s, generator=g) * 0.1
    return params, kw, (o, d, z, noise), g_ray.to(dev), g_w.to(dev)


TRAIN_SHAPES = [(6, 64, 16, 8), (6, 64, 16, 100), (8, 256, 64, 64),
                (2, 48, 24, 130), (1, 32, 8, 16)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", TRAIN_SHAPES)
def test_stash_forward_matches_plain(dev, dt, exact, depth, width, c, s):
    """The stash forward's outputs are the no-stash forward's, bit for
    bit; its stash is the plain version's within fp32 summation order
    (fp32: 1e-4 of the largest activation) or, at bf16, equal apart from
    values whose fp32 sum fell on the other side of a rounding boundary
    (and what those carry downstream): at most 2 % of the entries differ,
    none by more than 2^-6 of the largest activation."""
    params, kw, rays, _, _ = _train_case(dev, dt, exact, depth, width, c, s)
    # held to the no-stash launch of the kernel the stash form takes
    variant = fr.render_variant(kw.dims)
    key = "fused_render_fwd_stash" + ("" if variant == "wgmma" else "_mma")
    blk0, w0, _ = fr.render_fwd(kw, *rays, exact, stash=False,
                                variant=variant)
    before = dict(fr.LAUNCH_COUNTS)
    blk1, w1, st = fr.render_fwd(kw, *rays, exact, stash=True)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(before, **{key: before[key] + 1})
    assert torch.equal(blk0, blk1) and torch.equal(w0, w1)
    _, _, st_p = fr.render_fwd_plain(params, *rays, compute_dtype=dt,
                                     exact_encode=exact, stash=True)
    assert st.shape == st_p.shape and st.dtype == dt
    diff = (st.float() - st_p.float()).abs()
    scale = float(st_p.float().abs().max())
    if dt == torch.float32:
        assert float(diff.max()) <= 1e-4 * scale
    else:
        assert float((diff > 0).float().mean()) <= 0.02
        assert float(diff.max()) <= scale / 64


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,c,s", TRAIN_SHAPES)
def test_backward_kernels_match_plain(dev, dt, depth, width, c, s):
    """Both backward kernels on the stash the forward kernel wrote, against
    render_bwd_plain on the same stash: GRAD_TOL per tensor. Twice on the
    same inputs: the same bits (every sum has a fixed order)."""
    exact = dt == torch.float32
    params, kw, rays, g_ray, g_w = _train_case(dev, dt, exact, depth, width,
                                               c, s)
    o, d, z, noise = rays
    _, _, st = fr.render_fwd(kw, *rays, exact, stash=True)
    key = "fused_render_bwd" + (
        "" if fr.chain_variant(kw.dims, s) == "wgmma" else "_mma")
    key_w = fr._wgrad_key(fr.wgrad_variant(kw.dims))
    before = dict(fr.LAUNCH_COUNTS)
    got = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, exact)
    again = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, exact)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS[key] == before[key] + 2
    assert fr.LAUNCH_COUNTS[key_w] == before[key_w] + 2
    want = fr.render_bwd_plain(params, z, noise, d, st, g_ray, g_w,
                               compute_dtype=dt, exact_encode=exact)
    for a, b, r in zip(fr.flatten_params(want), fr.flatten_params(got),
                       fr.flatten_params(again)):
        assert a.shape == b.shape
        assert torch.equal(b, r)
        assert torch.isfinite(b).all()
        err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        assert err <= fr.GRAD_TOL[dt], err


@pytest.mark.parametrize("dt,variant", [(torch.bfloat16, "wgmma"),
                                        (torch.bfloat16, "mma"),
                                        (torch.float32, "fp32")])
@pytest.mark.parametrize("m", [5000, 64, 1])
def test_weight_gradient_kernel_alone(dev, dt, variant, m):
    """dW = A^T dZ on random buffers, many splits (one at m <= 64): each
    kernel against the plain product at fp32 summation-order tolerance,
    the same bits twice, one launch counted under its own key."""
    torch.manual_seed(4)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(dev))
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    st = torch.randn(m, lay.sc, device=dev).to(dt)
    dz = torch.randn(m, lay.dc, device=dev).to(dt)
    key = fr._wgrad_key(variant)
    before = fr.LAUNCH_COUNTS[key]
    got = fr.bwd_wgrad(kw, st, dz, variant=variant)
    again = fr.bwd_wgrad(kw, st, dz, variant=variant)
    want = fr.bwd_wgrad_plain(kw, st, dz)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS[key] == before + 2
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_train_function_on_card_matches_cpu(dev):
    """fused_render_train end to end (both kernels under autograd) against
    the same call on CPU tensors (the plain versions), fp32."""
    torch.manual_seed(5)
    m_cpu = NerfMLP(depth=6, width=64, out_dim=16)
    m_dev = NerfMLP(depth=6, width=64, out_dim=16)
    m_dev.load_state_dict(m_cpu.state_dict())
    m_dev.to(dev)
    o, d, z, noise = [t.cpu() for t in _inputs(dev, 21, 24)]
    # 6 fractional bits: o + d*z is exact on both sides
    o, d, z = [torch.round(t * 64) / 64 for t in (o, d, z)]
    z = torch.sort(z, -1).values
    grads = {}
    for name, m, to in (("cpu", m_cpu, lambda t: t),
                        ("card", m_dev, lambda t: t.to(dev))):
        blk, w = fr.fused_render_train(
            fr.mlp_params_from_module(m, detach=False), to(o), to(d), to(z),
            to(noise))
        ((blk[:, :17] ** 2).sum() + (w * torch.cos(w)).sum()).backward()
        grads[name] = [p.grad.cpu() for p in m.parameters()]
    for a, b in zip(grads["cpu"], grads["card"]):
        assert float((a - b).abs().max()) <= 2e-4 * float(a.abs().max())


def _jittered(rays, seed=11):
    """The rays' sample points moved by 1e-5 * U[0, 1), (N, S, 3) f32."""
    o, d, z, _ = rays
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((*z.shape, 3), generator=g).to(z.device)
    return (o[:, None] + d[:, None] * z[..., None] + 1e-5 * u).contiguous()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", [
    (6, 64, 16, 8), (6, 64, 16, 100), (8, 256, 64, 64), (2, 48, 24, 130),
])
def test_xyz_in_kernel_matches_plain(dev, dt, exact, depth, width, c, s):
    """The forward kernel reading one jittered coordinate per point,
    against render_fwd_plain(xyz=) on the same points: KERNEL_TOL."""
    params, kw, rays, _, _ = _train_case(dev, dt, exact, depth, width, c, s)
    o, d, z, noise = rays
    xyz = _jittered(rays)
    key = ("fused_render_fwd_xyz" if fr.render_variant(kw.dims) == "wgmma"
           else "fused_render_fwd_xyz_mma")
    before = dict(fr.LAUNCH_COUNTS)
    blk_k, w_k = fr.fused_render_apply(kw, None, d, z, noise, exact, xyz=xyz)
    blk_p, w_p = fr.render_fwd_plain(params, None, d, z, noise,
                                     compute_dtype=dt, exact_encode=exact,
                                     xyz=xyz)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(before, **{key: before[key] + 1})
    tw, tf, td = fr.KERNEL_TOL[dt]
    assert float((w_k - w_p).abs().max()) <= tw
    assert float((blk_k[:, :c] - blk_p[:, :c]).abs().max()) <= tf
    assert float((blk_k[:, c] - blk_p[:, c]).abs().max()) <= td
    assert torch.all(blk_k[:, c + 1:] == 0)


# the wgmma forward's shapes: its one build (WP 256, HP 128, CP 64) at a
# small, ragged width (240 / 120 / 40, zero-padded), at 8x256 and at other
# depths; S = 64 (two rays a tile, 37 rays: an odd last pair), 100 (a
# ragged last tile), 256 and 512 (the serve passes)
WGMMA_SHAPES = [(3, 240, 40, s) for s in (64, 100, 256, 512)] + [
    (8, 256, 64, s) for s in (64, 100, 256, 512)] + [
    (2, 256, 64, 100), (5, 240, 48, 130)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", WGMMA_SHAPES)
def test_wgmma_kernel_matches_plain_and_mma(dev, exact, depth, width, c, s):
    """The wgmma forward (bf16, rays-in) against render_fwd_plain and
    against the mma.sync forward on the same inputs, KERNEL_TOL[bf16] both:
    its sums run in another order. Exactly its counter moves."""
    torch.manual_seed(5)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, noise = _inputs(dev, 37, s)
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    assert fr.render_variant(kw.dims) == "wgmma"
    before = dict(fr.LAUNCH_COUNTS)
    blk_k, w_k = fr.fused_render_apply(kw, o, d, z, noise, exact)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(
        before, fused_render_fwd=before["fused_render_fwd"] + 1)
    blk_m, w_m, _ = fr.render_fwd(kw, o, d, z, noise, exact, stash=False,
                                  variant="mma")
    blk_p, w_p = fr.render_fwd_plain(params, o, d, z, noise,
                                     compute_dtype=torch.bfloat16,
                                     exact_encode=exact)
    tw, tf, td = fr.KERNEL_TOL[torch.bfloat16]
    for blk, w in ((blk_p, w_p), (blk_m, w_m)):
        assert float((w_k - w).abs().max()) <= tw
        assert float((blk_k[:, :c] - blk[:, :c]).abs().max()) <= tf
        assert float((blk_k[:, c] - blk[:, c]).abs().max()) <= td
    assert torch.all(blk_k[:, c + 1:] == 0)


@pytest.mark.parametrize("s", [64, 100])
def test_wgmma_xyz_in_without_jitter_equals_rays_in_bits(dev, s):
    """On the wgmma forward too, o + d*z handed in as xyz gives the
    rays-in launch's bits; each form counts under its own key."""
    _, kw, rays, _, _ = _train_case(dev, torch.bfloat16, False, 8, 256, 64,
                                    s)
    o, d, z, noise = rays
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    before = dict(fr.LAUNCH_COUNTS)
    a = fr.fused_render_apply(kw, o, d, z, noise, False)
    b = fr.fused_render_apply(kw, None, d, z, noise, False, xyz=xyz)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fr.LAUNCH_COUNTS == dict(
        before, fused_render_fwd=before["fused_render_fwd"] + 1,
        fused_render_fwd_xyz=before["fused_render_fwd_xyz"] + 1)


def test_wgmma_variant_refuses_what_it_does_not_take(dev):
    torch.manual_seed(6)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=2, width=256, out_dim=64).to(dev))
    o, d, z, noise = _inputs(dev, 8, 16)
    kw32 = fr.prepare_kernel_weights(params, 15, 4, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(kw32, o, d, z, noise, False, False, variant="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(kw32, o, d, z, noise, False, True, variant="wgmma")
    narrow = fr.prepare_kernel_weights(fr.mlp_params_from_module(
        NerfMLP(depth=2, width=128, out_dim=64).to(dev)), 15, 4,
        torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(narrow, o, d, z, noise, False, False, variant="wgmma")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stash", [False, True])
def test_xyz_in_without_jitter_equals_rays_in_bits(dev, dt, stash):
    """o + d*z handed in as xyz: outputs and stash of the rays-in launch,
    bit for bit (S = 100: a partial last chunk)."""
    _, kw, rays, _, _ = _train_case(dev, dt, False, 6, 64, 16, 100)
    o, d, z, noise = rays
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    a = fr.render_fwd(kw, o, d, z, noise, False, stash=stash)
    b = fr.render_fwd(kw, None, d, z, noise, False, stash=stash, xyz=xyz)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[2] is None) == (b[2] is None) == (not stash)
    if stash:
        assert torch.equal(a[2], b[2])


# the stash route's wgmma pair at the served widths: S = 64 (two rays a
# tile, 37 rays: an odd last pair), 100 (a ragged tile), 130 (two tiles a
# ray, the second one's rows mostly past S), at depth 8 and a ragged 3 x
# 240 / C 40
WGMMA_TRAIN_SHAPES = [(8, 256, 64, s) for s in (64, 100, 130)] + [
    (3, 240, 40, s) for s in (64, 130)]


def _stash_close(st, st_p):
    """The bf16 stash bound of test_stash_forward_matches_plain."""
    diff = (st.float() - st_p.float()).abs()
    scale = float(st_p.float().abs().max())
    return (float((diff > 0).float().mean()) <= 0.02
            and float(diff.max()) <= scale / 64)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", WGMMA_TRAIN_SHAPES)
def test_wgmma_stash_forward_matches_plain_and_inference_bits(
        dev, monkeypatch, exact, depth, width, c, s):
    """The wgmma stash forward: its ray block and weights are the wgmma
    inference forward's bits (the stash only adds stores), its stash is
    the plain version's and the mma.sync stash form's within the bf16
    stash bound (STASH_TOL_BF16 in chip_smoke.py), every row of every ray
    is written and none past them; xyz-in without jitter gives the
    rays-in stash's bits."""
    params, kw, rays, _, _ = _train_case(dev, torch.bfloat16, exact, depth,
                                         width, c, s)
    assert fr.render_variant(kw.dims) == "wgmma"
    lay = fr.grad_layout(kw.dims)
    n = rays[2].shape[0]
    blk0, w0, _ = fr.render_fwd(kw, *rays, exact, stash=False)
    before = dict(fr.LAUNCH_COUNTS)
    # the stash allocated over NaN, with a guard row after it: every row
    # is written, none past N * S
    buf = torch.full((n * s + 1, lay.sc), float("nan"), device=dev,
                     dtype=torch.bfloat16)
    real_empty = torch.empty

    def into_buf(shape, **kw_):
        if tuple(shape) == (n * s, lay.sc):
            return buf[:n * s]
        return real_empty(shape, **kw_)

    monkeypatch.setattr(torch, "empty", into_buf)
    blk1, w1, st = fr.render_fwd(kw, *rays, exact, stash=True)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(
        before, fused_render_fwd_stash=before["fused_render_fwd_stash"] + 1)
    assert torch.equal(blk0, blk1) and torch.equal(w0, w1)
    assert not torch.isnan(st.float()).any()
    assert torch.isnan(buf[n * s].float()).all()
    _, _, st_p = fr.render_fwd_plain(params, *rays,
                                     compute_dtype=torch.bfloat16,
                                     exact_encode=exact, stash=True)
    _, _, st_m = fr.render_fwd(kw, *rays, exact, stash=True, variant="mma")
    assert _stash_close(st, st_p) and _stash_close(st, st_m)
    o, d, z, noise = rays
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    _, _, st_x = fr.render_fwd(kw, None, d, z, noise, exact, stash=True,
                               xyz=xyz)
    assert torch.equal(st_x, st)


@pytest.mark.parametrize("depth,width,c,s", WGMMA_TRAIN_SHAPES)
def test_wgmma_chain_matches_plain_on_one_stash(dev, depth, width, c, s):
    """The wgmma chain against bwd_chain_plain on one shared stash (the
    wgmma forward's): the dz rows (every column of every row; GRAD_TOL of
    each block's largest value) and the bias and dir-encode sums
    (GRAD_TOL of the largest); the whole backward against
    render_bwd_plain on the same stash, GRAD_TOL per tensor; twice: the
    same bits. Exactly its counter moves."""
    params, kw, rays, g_ray, g_w = _train_case(dev, torch.bfloat16, False,
                                               depth, width, c, s)
    o, d, z, noise = rays
    assert fr.chain_variant(kw.dims, s) == "wgmma"
    _, _, st = fr.render_fwd(kw, *rays, False, stash=True)
    dir_blk = fr.dir_block(kw, d, False)
    before = dict(fr.LAUNCH_COUNTS)
    dz, gb = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w)
    dz2, gb2 = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS == dict(
        before, fused_render_bwd=before["fused_render_bwd"] + 2)
    assert torch.equal(dz, dz2) and torch.equal(gb, gb2)
    dz_p, gb_p = fr.bwd_chain_plain(kw, z, noise, dir_blk, st, g_ray, g_w)
    tol = fr.GRAD_TOL[torch.bfloat16]
    assert float((gb - gb_p).abs().max()) <= tol * float(gb_p.abs().max())
    lay = fr.grad_layout(kw.dims)
    wp = kw.dims["WP"]
    cols = [(i * wp, wp) for i in range(kw.dims["L"])] + [
        (lay.d_hf, wp), (lay.d_sig, 32), (lay.d_ddd, kw.dims["HP"]),
        (lay.d_feat, kw.dims["CP"])]
    for c0, w in cols:
        a, b = dz_p[:, c0:c0 + w].float(), dz[:, c0:c0 + w].float()
        assert float((a - b).abs().max()) <= tol * max(
            float(a.abs().max()), 1e-30), c0
    assert torch.all(dz[:, lay.d_sig + 1:lay.d_sig + 32] == 0)
    got = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, False)
    again = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, False)
    want = fr.render_bwd_plain(params, z, noise, d, st, g_ray, g_w,
                               compute_dtype=torch.bfloat16,
                               exact_encode=False)
    for a, b, r in zip(fr.flatten_params(want), fr.flatten_params(got),
                       fr.flatten_params(again)):
        assert torch.equal(b, r) and torch.isfinite(b).all()
        err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        assert err <= tol, err


# the recompute backward against the stash backward on the same inputs, per
# tensor over its largest value: the same dz rows, the fp32 sums over the
# points grouped by slab
RECOMPUTE_VS_STASH = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# the recompute backward against its plain version from the same INPUTS:
# each side recomputes its own forward (sinf against torch.sin, another
# order of sums), so a ReLU whose input is within that difference of zero
# is open on one side and shut on the other, and at these few points (37
# rays) one such point moves a tensor's gradient visibly: measured 2.9e-4
# at fp32 on 37 x 64 points, where the same backward on one shared stash
# agrees to GRAD_TOL (test_backward_kernels_match_plain)
RECOMPUTE_VS_PLAIN = {torch.float32: 2e-3, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("variant", [None, "mma"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rays_in", [True, False])
@pytest.mark.parametrize("depth,width,c,s", TRAIN_SHAPES)
def test_recompute_backward_matches_plain(dev, variant, dt, rays_in, depth,
                                          width, c, s):
    """The recompute backward (slabs of 10 of the 37 rays: a ragged last
    slab), on the variant its shape takes (wgmma at bf16 8x256) and on
    mma.sync, against its plain version, RECOMPUTE_VS_PLAIN per tensor;
    twice: the same bits; against the stash backward of the same variant's
    pair on a stash of the same inputs: RECOMPUTE_VS_STASH."""
    exact = dt == torch.float32
    params, kw, rays, g_ray, g_w = _train_case(dev, dt, exact, depth, width,
                                               c, s)
    o, d, z, noise = rays
    xyz = None if rays_in else _jittered(rays)
    variant = variant or fr.recompute_variant(kw.dims, s)
    key = ("fused_render_bwd_recompute" if rays_in
           else "fused_render_bwd_recompute_xyz")
    key += "" if variant == "wgmma" else "_mma"
    before = dict(fr.LAUNCH_COUNTS)
    got = fr.fused_render_bwd_recompute(kw, o, d, z, noise, g_ray, g_w,
                                        exact, xyz, slab_rays=10,
                                        variant=variant)
    again = fr.fused_render_bwd_recompute(kw, o, d, z, noise, g_ray, g_w,
                                          exact, xyz, slab_rays=10,
                                          variant=variant)
    torch.cuda.synchronize()
    # and K2's weight gradient once a slab (the kernel wgrad_variant names)
    key_w = fr._wgrad_key(fr.wgrad_variant(kw.dims))
    assert fr.LAUNCH_COUNTS == dict(
        before, **{key: before[key] + 2,
                   key_w: before[key_w] + 2 * -(-z.shape[0] // 10)})
    want = fr.render_bwd_recompute_plain(
        params, o, d, z, noise, g_ray, g_w, compute_dtype=dt,
        exact_encode=exact, xyz=xyz, slab_rays=10)
    # the stash route on the pair of the same variant, whose stash the
    # slabs recompute
    _, _, st = fr.render_fwd(kw, o, d, z, noise, exact, stash=True, xyz=xyz,
                             variant=variant)
    k2 = fr.fused_render_bwd(kw, z, noise, d, st, g_ray, g_w, exact,
                             variant=variant)
    for a, b, r, q in zip(fr.flatten_params(want), fr.flatten_params(got),
                          fr.flatten_params(again), fr.flatten_params(k2)):
        assert a.shape == b.shape
        assert torch.equal(b, r)
        assert torch.isfinite(b).all()
        scale = max(float(a.abs().max()), 1e-30)
        assert float((q - b).abs().max()) / scale <= RECOMPUTE_VS_STASH[dt]
        assert float((a - b).abs().max()) / scale <= RECOMPUTE_VS_PLAIN[dt]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,width,c,s", [(6, 64, 16, 100),
                                             (8, 256, 64, 100),
                                             (3, 240, 40, 64)])
def test_recompute_scratch_rows_are_the_stash_routes(dev, dt, depth, width,
                                                     c, s):
    """One slab over all rays: the scratch the recompute backward leaves is
    the stash route's stash and dz buffer on the pair of the variant the
    shape takes (wgmma at bf16 and the served widths, else mma.sync), bit
    for bit, and so are the gradients."""
    exact = dt == torch.float32
    _, kw, rays, g_ray, g_w = _train_case(dev, dt, exact, depth, width, c, s)
    o, d, z, noise = rays
    variant = fr.recompute_variant(kw.dims, s)
    gw, gb, (st_r, dz_r) = fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w,
                                            exact, slab_rays=37)
    _, _, st = fr.render_fwd(kw, o, d, z, noise, exact, stash=True,
                             variant=variant)
    dz, gb_s = fr.bwd_chain(kw, z, noise, fr.dir_block(kw, d, exact), st,
                            g_ray, g_w, variant=variant)
    gw_s = fr.bwd_wgrad(kw, st, dz)
    torch.cuda.synchronize()
    assert torch.equal(st_r, st) and torch.equal(dz_r, dz)
    assert torch.equal(gb, gb_s) and torch.equal(gw, gw_s)


@pytest.mark.parametrize("dt,width,c", [(torch.float32, 64, 16),
                                        (torch.bfloat16, 256, 64)])
@pytest.mark.parametrize("slab_rays", [1, 5, 37, 1000])
def test_recompute_slab_size_does_not_change_the_gradients(dev, dt, width, c,
                                                           slab_rays):
    """Each variant (mma.sync at fp32, wgmma at bf16 8x256): slabs of any
    size give the same dz rows, so the gradients of one slab's bits, up to
    the grouping of the fp32 sums over the points (RECOMPUTE_VS_STASH)."""
    exact = dt == torch.float32
    _, kw, rays, g_ray, g_w = _train_case(dev, dt, exact, 6, width, c, 24)
    want = fr.fused_render_bwd_recompute(kw, *rays, g_ray, g_w, exact, None,
                                         slab_rays=37)
    got = fr.fused_render_bwd_recompute(kw, *rays, g_ray, g_w, exact, None,
                                        slab_rays=slab_rays)
    for a, b in zip(fr.flatten_params(want), fr.flatten_params(got)):
        if slab_rays >= 37:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= (
                RECOMPUTE_VS_STASH[dt] * float(a.abs().max()))


@pytest.mark.parametrize("rays_in", [True, False])
def test_recompute_train_function_on_card_matches_cpu(dev, rays_in):
    """fused_render_train(stash=False) end to end (forward kernel, then
    the recompute backward under autograd) against the same call on CPU
    tensors (the plain versions), fp32."""
    torch.manual_seed(5)
    m_cpu = NerfMLP(depth=6, width=64, out_dim=16)
    m_dev = NerfMLP(depth=6, width=64, out_dim=16)
    m_dev.load_state_dict(m_cpu.state_dict())
    m_dev.to(dev)
    o, d, z, noise = [t.cpu() for t in _inputs(dev, 21, 24)]
    o, d, z = [torch.round(t * 64) / 64 for t in (o, d, z)]
    z = torch.sort(z, -1).values
    xyz = None if rays_in else _jittered((o, d, z, noise))
    grads = {}
    for name, m, to in (("cpu", m_cpu, lambda t: t),
                        ("card", m_dev, lambda t: t.to(dev))):
        blk, w = fr.fused_render_train(
            fr.mlp_params_from_module(m, detach=False), to(o), to(d), to(z),
            to(noise), xyz=None if xyz is None else to(xyz), stash=False,
            slab_rays=8)
        assert blk.grad_fn.stash is None
        ((blk[:, :17] ** 2).sum() + (w * torch.cos(w)).sum()).backward()
        grads[name] = [p.grad.cpu() for p in m.parameters()]
    for a, b in zip(grads["cpu"], grads["card"]):
        assert float((a - b).abs().max()) <= 2e-4 * float(a.abs().max())


@pytest.mark.parametrize("n,s,c", [(300, 20, 48), (37, 200, 16), (64, 1, 3),
                                   (9, 130, 129), (5, 33, 256)])
def test_composite_kernel_matches_plain(dev, n, s, c):
    """The compositing kernel against core.compositing.composite on the
    same inputs (a fifth of the densities negative), ragged S and C."""
    from crnerf_tpu_torch.core.compositing import composite
    from crnerf_tpu_torch.ops import composite as comp

    g = torch.Generator().manual_seed(n + s + c)
    feats = torch.rand(n, s, c, generator=g).to(dev)
    sigmas = (torch.rand(n, s, generator=g) * 3.75 - 0.75).to(dev)
    z = torch.sort(torch.rand(n, s, generator=g) * 5 + 0.5, -1).values.to(dev)
    before = comp.LAUNCH_COUNTS["composite"]
    got = comp.composite_apply(feats, sigmas, z)
    want = composite(feats, sigmas, z)
    torch.cuda.synchronize()
    assert comp.LAUNCH_COUNTS["composite"] == before + 1
    for a, b, tol in zip(got, want, comp.KERNEL_TOL):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert float((a - b).abs().max()) <= tol


def test_composite_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from crnerf_tpu_torch.ops.composite import composite_apply

    f = torch.rand(4, 8, 16, device=dev)
    sg, z = torch.rand(4, 8, device=dev), torch.rand(4, 8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        composite_apply(f, sg.double(), z)
    with pytest.raises(ValueError, match="contiguous"):
        composite_apply(f, sg.T.contiguous().T, z)
    with pytest.raises(ValueError, match="on cpu"):
        composite_apply(f, sg.cpu(), z)
    with pytest.raises(ValueError, match="C <= 256"):
        composite_apply(torch.rand(2, 3, 300, device=dev),
                        torch.rand(2, 3, device=dev),
                        torch.rand(2, 3, device=dev))



# ------------------------------------------------ the per-point fused MLP
MLP_SHAPES = [(6, 64, 16, 8), (6, 64, 16, 100), (8, 256, 64, 64),
              (2, 48, 24, 130), (1, 32, 8, 16)]


def _mlp_case(dev, dt, depth, width, c, s, dir_rep, n=37, seed=1):
    from crnerf_tpu_torch.ops import fused_mlp as fm

    torch.manual_seed(seed)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, _ = _inputs(dev, n, s)
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3).contiguous()
    if dir_rep == 1:
        d = d.repeat_interleave(s, 0).contiguous()
    g = torch.Generator().manual_seed(seed + 7)
    g_feat = (torch.randn(n * s, c, generator=g) * 0.1).to(dev)
    g_sig = (torch.randn(n * s, generator=g) * 0.1).to(dev)
    return fm, fm.prepare_mlp_weights(params, 15, 4, dt), xyz, d, g_feat, g_sig


@pytest.mark.parametrize("dt,exact", [(torch.float32, True),
                                      (torch.bfloat16, False)])
@pytest.mark.parametrize("per_ray", [True, False])
@pytest.mark.parametrize("depth,width,c,s", MLP_SHAPES)
def test_mlp_forward_matches_plain(dev, dt, exact, per_ray, depth, width, c,
                                   s):
    """37 rays x s points is a multiple of no tile; a direction per ray and
    one per point; widths and C that need zero padding."""
    rep = s if per_ray else 1
    fm, mkw, xyz, d, _, _ = _mlp_case(dev, dt, depth, width, c, s, rep)
    key = ("fused_mlp_fwd" if fm.mlp_variant(mkw.kw.dims) == "wgmma"
           else "fused_mlp_fwd_mma")
    before = dict(fm.LAUNCH_COUNTS)
    f_k, s_k = fm.fused_mlp_apply(mkw, xyz, d, exact, rep)
    f_p, s_p = fm.mlp_fwd_plain(mkw, xyz, d, exact, rep)
    torch.cuda.synchronize()
    assert fm.LAUNCH_COUNTS == dict(before, **{key: before[key] + 1})
    assert f_k.shape == (37 * s, c) and s_k.shape == (37 * s,)
    tf, ts = fm.KERNEL_TOL[dt]
    assert float((f_k - f_p).abs().max()) <= tf
    assert float((s_k - s_p).abs().max()) <= ts * max(1.0, float(s_p.max()))


@pytest.mark.parametrize("dt,exact", [(torch.float32, True),
                                      (torch.bfloat16, False)])
@pytest.mark.parametrize("slab", [None, 100])
@pytest.mark.parametrize("depth,width,c,s", MLP_SHAPES)
def test_mlp_backward_matches_plain_on_one_forward(dev, dt, exact, slab,
                                                   depth, width, c, s):
    """The backward kernels, each variant the shape takes (mma.sync; at
    bf16 and the served widths also wgmma), with every point in one slab
    against the plain chain and weight gradient on the stash they
    recomputed (GRAD_TOL); twice for the same bits; in slabs of 100 points
    (which end inside a tile and inside a ray) against one slab, up to the
    grouping of fp32 sums. Each launch counts under its variant."""
    fm, mkw, xyz, d, g_feat, g_sig = _mlp_case(dev, dt, depth, width, c, s, s)
    m = xyz.shape[0]
    lay = fm.mlp_grad_layout(mkw.kw.dims)
    variants = ["mma"] + (["wgmma"] if fm.mlp_bwd_variant(mkw.kw.dims)
                          == "wgmma" else [])
    for variant in variants:
        key = "fused_mlp_bwd" if variant == "wgmma" else "fused_mlp_bwd_mma"
        before = dict(fm.LAUNCH_COUNTS)
        gw_1, gb_1, (st, dz) = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact,
                                          s, m, variant=variant)
        gw_k, gb_k, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, s,
                                   slab, variant=variant)
        gw_2, gb_2, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, s,
                                   slab, variant=variant)
        torch.cuda.synchronize()
        assert fm.LAUNCH_COUNTS == dict(before, **{key: before[key] + 3})
        assert torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
        dz_p, gb_p = fm.mlp_chain_plain(mkw, st, g_feat, g_sig)
        gw_p = fr.bwd_wgrad_plain(mkw.kw, st, dz_p, lay)
        want = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_p, gb_p))
        one = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_1, gb_1))
        got = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_k, gb_k))
        for a, b, k in zip(want, one, got):
            scale = float(a.abs().max().clamp_min(1e-30))
            assert float((a - b).abs().max()) <= fm.GRAD_TOL[dt] * scale
            assert float((b - k).abs().max()) <= 5e-4 * scale


def _served_mlp_case(dev, n, s, rep=0, seed=9):
    """8x256, C 64, bf16 (the wgmma backward's shape): the points of n rays
    x s samples, a direction a ray (or a point: rep 1), cotangents."""
    from crnerf_tpu_torch.ops import fused_mlp as fm

    torch.manual_seed(seed)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(dev))
    mkw = fm.prepare_mlp_weights(params, 15, 4, torch.bfloat16)
    assert fm.mlp_bwd_variant(mkw.kw.dims) == "wgmma"
    o, d, z, _ = _inputs(dev, n, s)
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3).contiguous()
    rep = rep or s
    if rep == 1:
        d = d.repeat_interleave(s, 0).contiguous()
    g = torch.Generator().manual_seed(seed + 7)
    g_feat = (torch.randn(n * s, 64, generator=g) * 0.1).to(dev)
    g_sig = (torch.randn(n * s, generator=g) * 0.1).to(dev)
    return fm, mkw, xyz, d, rep, g_feat, g_sig


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n,s,rep", [(37, 20, 0), (999, 77, 0), (300, 64, 1)])
def test_wgmma_mlp_slab_stash_rows_are_the_forward_bits(dev, exact, n, s,
                                                        rep):
    """The wgmma backward's slab stash rows (every point in one slab) are,
    bit for bit, the wgmma stash forward's, and that forward's features
    and sigma are the wgmma no-stash forward's (route C's training
    forward): the stores change nothing, so the slabs recompute the masks
    the forward used. In slabs of 1000 points the last slab's rows are
    those points' rows."""
    fm, mkw, xyz, d, rep, g_feat, g_sig = _served_mlp_case(dev, n, s, rep)
    m = xyz.shape[0]
    f0, s0 = fm.mlp_fwd(mkw, xyz, d, exact, rep)
    f1, s1, st = fm.mlp_fwd(mkw, xyz, d, exact, rep, stash=True)
    _, _, (st_1, _) = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, rep, m)
    _, _, (st_s, _) = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, rep, 1000)
    torch.cuda.synchronize()
    assert torch.equal(f0, f1) and torch.equal(s0, s1)
    assert torch.equal(st_1, st)
    last = (m - 1) // 1000 * 1000
    assert torch.equal(st_s[:m - last], st[last:])
    # the stash itself: the plain stash forward's rows, up to bf16 steps
    _, _, st_p = fm.mlp_fwd_plain(mkw, xyz, d, exact, rep, stash=True)
    diff = (st.float() - st_p.float()).abs()
    assert float(diff.max()) <= float(st_p.float().abs().max()) / 64
    assert float((diff > 0).float().mean()) <= 0.02


@pytest.mark.parametrize("slab", [100, 1000, 5000])
def test_wgmma_mlp_slab_size_keeps_the_gradients(dev, slab):
    """The wgmma backward at other slab sizes than one: the same gradients
    up to the grouping of the fp32 sums over the points (the bf16 slab
    bound, 5e-4 of each tensor's largest), and the same bits twice."""
    fm, mkw, xyz, d, rep, g_feat, g_sig = _served_mlp_case(dev, 101, 99)
    m = xyz.shape[0]
    gw_1, gb_1, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, rep, m)
    gw_k, gb_k, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, rep, slab)
    gw_2, gb_2, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, rep, slab)
    torch.cuda.synchronize()
    assert torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
    one = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_1, gb_1))
    got = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_k, gb_k))
    for a, b in zip(one, got):
        scale = float(a.abs().max().clamp_min(1e-30))
        assert float((a - b).abs().max()) <= 5e-4 * scale


# the wgmma forward at the shapes of chip_smoke.py's phase 4d: (rays,
# samples, dir_rep (0: one a ray), p_base)
WGMMA_MLP_SHAPES = [(1024, 128, 0, 0), (1024, 128, 1, 0), (999, 77, 0, 0),
                    (999, 77, 1, 0), (1024, 128, 0, 1000),
                    (1024, 128, 1, 1000), (8192, 256, 0, 0),
                    (8192, 512, 0, 0)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n,s,rep,p_base", WGMMA_MLP_SHAPES)
def test_wgmma_mlp_forward_matches_plain_and_mma(dev, exact, n, s, rep,
                                                 p_base):
    """The wgmma fused-MLP forward (8x256, C 64, bf16) on the points of n
    rays x s samples from point p_base on, against mlp_fwd_plain (over
    slices of 128 Ki points) and against the mma.sync forward on the same
    inputs: KERNEL_TOL[bf16] both. Exactly its counter moves."""
    from crnerf_tpu_torch.ops import fused_mlp as fm

    rep = rep or s
    torch.manual_seed(9)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(dev))
    mkw = fm.prepare_mlp_weights(params, 15, 4, torch.bfloat16)
    assert fm.mlp_variant(mkw.kw.dims) == "wgmma"
    o, d, z, _ = _inputs(dev, n, s)
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    xyz = xyz[p_base:].contiguous()
    if rep == 1:
        d = d.repeat_interleave(s, 0).contiguous()
    before = dict(fm.LAUNCH_COUNTS)
    f_k, s_k = fm.mlp_fwd(mkw, xyz, d, exact, rep, p_base)
    torch.cuda.synchronize()
    assert fm.LAUNCH_COUNTS == dict(
        before, fused_mlp_fwd=before["fused_mlp_fwd"] + 1)
    f_m, s_m = fm.mlp_fwd(mkw, xyz, d, exact, rep, p_base, variant="mma")
    tf, ts = fm.KERNEL_TOL[torch.bfloat16]
    scale = max(1.0, float(s_k.max()))
    assert float((f_k - f_m).abs().max()) <= tf
    assert float((s_k - s_m).abs().max()) <= ts * scale
    m, per = xyz.shape[0], (128 * 1024 // rep) * rep
    for i in range(0, m, per):
        pts = slice(i, min(i + per, m))
        if p_base + i:
            f_p, s_p = fm.mlp_fwd_plain(mkw, xyz[pts], d, exact, rep,
                                        p_base=p_base + i)
        else:   # the directions of exactly these points
            f_p, s_p = fm.mlp_fwd_plain(mkw, xyz[pts], d[:pts.stop // rep],
                                        exact, rep)
        assert float((f_k[pts] - f_p).abs().max()) <= tf
        assert float((s_k[pts] - s_p).abs().max()) <= ts * scale


def test_wgmma_mlp_forward_refuses_what_it_does_not_take(dev):
    from crnerf_tpu_torch.ops import fused_mlp as fm

    _, mkw32, xyz, d, _, _ = _mlp_case(dev, torch.float32, 2, 256, 64, 16,
                                       16)
    with pytest.raises(ValueError, match="does not take"):
        fm.mlp_fwd(mkw32, xyz, d, False, 16, variant="wgmma")
    _, narrow, xyz, d, _, _ = _mlp_case(dev, torch.bfloat16, 2, 128, 64, 16,
                                        16)
    with pytest.raises(ValueError, match="does not take"):
        fm.mlp_fwd(narrow, xyz, d, False, 16, variant="wgmma")
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fm.mlp_fwd(narrow, xyz, d, False, 16, variant="tma")


@pytest.mark.parametrize("dt,exact,depth,width,c,n,s,keys", [
    (torch.float32, True, 6, 64, 16, 37, 20,
     ("fused_mlp_fwd_mma", "fused_mlp_bwd_mma")),
    (torch.bfloat16, False, 3, 256, 64, 1024, 64,
     ("fused_mlp_fwd", "fused_mlp_bwd")),
])
def test_mlp_train_function_on_card_matches_cpu(dev, dt, exact, depth, width,
                                                c, n, s, keys):
    """fused_mlp_train under autograd, on each variant (fp32: mma.sync;
    bf16 at the served widths: wgmma): the card's kernels against the
    CPU's plain versions from the same inputs (the loose bound: another
    forward, whose knife-edge ReLUs move a point's whole term, so at bf16
    enough points that one such term is small beside a gradient's
    largest); the forward and the backward each launch once, on the
    backward's variant."""
    from crnerf_tpu_torch.ops import fused_mlp as fm

    torch.manual_seed(5)
    mlp = NerfMLP(depth=depth, width=width, out_dim=c)
    o, d, z, _ = _inputs(torch.device("cpu"), n, s)
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    g = torch.Generator().manual_seed(6)
    g_feat = torch.randn(n * s, c, generator=g) * 0.1
    g_sig = torch.randn(n * s, generator=g) * 0.1
    grads = {}
    for name, where in (("cpu", torch.device("cpu")), ("card", dev)):
        m = NerfMLP(depth=depth, width=width, out_dim=c)
        m.load_state_dict(mlp.state_dict())
        m.to(where)
        p = fr.mlp_params_from_module(m, detach=False)
        before = dict(fm.LAUNCH_COUNTS)
        f, sig = fm.fused_mlp_train(p, xyz.to(where), d.to(where),
                                    compute_dtype=dt, exact_encode=exact,
                                    dir_rep=s)
        ((f * g_feat.to(where)).sum()
         + (sig * g_sig.to(where)).sum()).backward()
        want = dict(before, **{k: before[k] + 1 for k in keys}) \
            if name == "card" else before
        assert fm.LAUNCH_COUNTS == want
        grads[name] = {k: v.grad.cpu() for k, v in m.named_parameters()}
    for k, a in grads["cpu"].items():
        tol = fm.GRAD_TOL_FROM_INPUTS[dt] * float(a.abs().max())
        assert float((grads["card"][k] - a).abs().max()) <= tol, k


def test_mlp_wrapper_rejects_what_the_kernel_does_not_take(dev):
    fm, mkw, xyz, d, g_feat, g_sig = _mlp_case(dev, torch.float32, 4, 32, 16,
                                               16, 16)
    with pytest.raises(ValueError, match="float32"):
        fm.fused_mlp_apply(mkw, xyz.double(), d, dir_rep=16)
    with pytest.raises(ValueError, match="does not cover"):
        fm.fused_mlp_apply(mkw, xyz, d, dir_rep=15)
    with pytest.raises(ValueError, match="on cpu"):
        fm.fused_mlp_apply(mkw, xyz, d.cpu(), dir_rep=16)
    with pytest.raises(ValueError, match="shape"):
        fm.mlp_bwd(mkw, xyz, d, g_feat[:, :8].contiguous(), g_sig, True, 16)


@pytest.mark.parametrize("field", ["pallas_render", "use_pallas"])
def test_per_point_routes_on_card_match_cpu(dev, field):
    """The served slice on the fused MLP + composite route and on the
    module route at a small fp32 config: the card against the CPU."""
    from crnerf_tpu_torch.config import Config
    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(N_samples=16, N_importance=16, netdepth=6, netwidth=64,
                 nerf_out_dim=16, appearance_wh=(64, 48), chunk=256,
                 N_emb_xyz=10, **{field: False})
    torch.manual_seed(3)
    cpu_sys = CrNerfSystem(cfg).eval()
    card_sys = CrNerfSystem(cfg).eval()
    card_sys.load_state_dict(cpu_sys.state_dict())
    card_sys.to(dev)
    style = np.random.default_rng(0).uniform(-1, 1, (1, 48, 64, 3)).astype(
        np.float32)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5]], np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    before_mlp, before_render = dict(fm.LAUNCH_COUNTS), dict(fr.LAUNCH_COUNTS)
    out = {}
    for name, system in (("cpu", cpu_sys), ("card", card_sys)):
        r = Renderer(cfg, system)
        out[name] = r.fetch(r.render_frame_cam_async(c2w, K, 0.5, 2.5,
                                                     (24, 32), style))
    # 768 rays in tiles of 256: a coarse and a fine launch per tile, on
    # the mma.sync kernel at fp32
    want = 6 if field == "pallas_render" else 0
    assert fm.LAUNCH_COUNTS == dict(
        before_mlp,
        fused_mlp_fwd_mma=before_mlp["fused_mlp_fwd_mma"] + want)
    assert fr.LAUNCH_COUNTS == before_render
    np.testing.assert_allclose(out["card"]["rgb"], out["cpu"]["rgb"],
                               atol=1e-3)
    np.testing.assert_allclose(out["card"]["mask"], out["cpu"]["mask"],
                               atol=1e-4)


# ------------------------------------------------ the conv and sincos spikes
def _moved(cv, before):
    """The launch counters that moved since ``before``, by how much."""
    return {k: v - before[k] for k, v in cv.LAUNCH_COUNTS.items()
            if v != before[k]}


@pytest.mark.parametrize("n,h,w,c,co", [
    (2, 16, 24, 64, 64), (3, 37, 53, 40, 72), (2, 19, 23, 13, 21),
    (1, 1, 1, 8, 8), (2, 32, 48, 64, 64), (1, 12, 20, 128, 64),
])
def test_conv3x3_kernels_match_plain(dev, n, h, w, c, co):
    """The 3x3 forward and weight-gradient kernels against their plain
    versions (ops.conv.KERNEL_TOL_F32 of the largest value): S1's main
    width (C = Co = 64) twice, ragged with C and Co multiples of 8, ragged
    otherwise, one pixel, two input-channel chunks (the kernel streams
    instead of staying in shared memory; two gradient blocks). All but the
    ragged shape that is no multiple of 8 take the wgmma kernels, that one
    the mma.sync ones: the counter of the variant moves, no other. The
    gradient twice gives the same bits."""
    from crnerf_tpu_torch.ops import conv as cv

    g = torch.Generator().manual_seed(5)
    xpad = torch.randn(n, h + 2, w + 2, c, generator=g).bfloat16().to(dev)
    k = torch.randn(3, 3, c, co, generator=g).bfloat16().to(dev)
    dy = torch.randn(n, h, w, co, generator=g).bfloat16().to(dev)
    suffix = "" if c % 8 == 0 and co % 8 == 0 else "_mma"
    before = dict(cv.LAUNCH_COUNTS)
    fwd = cv.conv3x3_valid_fwd(xpad, k)
    dw = cv.conv3x3_dw(xpad, dy)
    torch.cuda.synchronize()
    assert _moved(cv, before) == {"conv3x3_fwd" + suffix: 1,
                                  "conv3x3_dw" + suffix: 1}
    for got, want in ((fwd, cv.conv_valid_plain(xpad, k)),
                      (dw, cv.conv3x3_dw_plain(xpad, dy))):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= cv.KERNEL_TOL_F32 * float(want.abs().max())
    assert torch.equal(dw, cv.conv3x3_dw(xpad, dy))


@pytest.mark.parametrize("shape,f", [((2, 16, 24, 64), 64),
                                     ((2, 38, 54, 10), 6),
                                     ((1, 22, 30, 3), 5),
                                     ((2, 10, 14, 128), 128),
                                     ((1, 10, 14, 32), 16),
                                     ((1, 10, 14, 64), 16)])
def test_packed_conv_kernel_matches_plain_and_the_3x3(dev, shape, f):
    """The packed conv against its plain version and, after _d2s, against
    the 3x3 kernel: S4's two widths (4C = 256, one 256-wide column block;
    4C = 512, two), ragged with 4C and 4F multiples of 8 (the wgmma
    kernel), ragged otherwise (the mma.sync kernel), 4F = 64 over two and
    four input chunks (the kernel stays in shared memory, then streams);
    the counter of the variant moves, no other."""
    from crnerf_tpu_torch.ops import conv as cv

    g = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=g).bfloat16().to(dev)
    k3 = (torch.randn(3, 3, shape[-1], f, generator=g) * 0.05).bfloat16().to(
        dev)
    xp_pad = cv.packed_reflect_pad1(cv._s2d(x)).contiguous()
    k2 = cv._pack_kernel3x3(k3).contiguous()
    before = dict(cv.LAUNCH_COUNTS)
    got = cv.packed_conv(xp_pad, k2)
    torch.cuda.synchronize()
    wgmma = 4 * shape[-1] % 8 == 0 and 4 * f % 8 == 0
    assert _moved(cv, before) == {
        "packed_conv" if wgmma else "packed_conv_mma": 1}
    want = cv.conv_valid_plain(xp_pad, k2, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) \
        <= cv.KERNEL_TOL_BF16 * top
    three = cv.conv3x3_valid_fwd(cv.reflect_pad(x, 1).contiguous(), k3)
    assert float((cv._d2s(got).float() - three).abs().max()) \
        <= (2.0 ** -8 + cv.KERNEL_TOL_F32) * float(three.abs().max())


def test_conv_wrappers_reject_what_the_kernels_do_not_take(dev):
    from crnerf_tpu_torch.ops import conv as cv

    x = torch.zeros(1, 6, 6, 8, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 8, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        cv.conv3x3_valid_fwd(x.float(), k.float())
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_valid_fwd(x.transpose(1, 2), k)
    with pytest.raises(ValueError, match="shape"):
        cv.conv3x3_valid_fwd(x, k[:, :, :4])
    with pytest.raises(ValueError, match="on cpu"):
        cv.conv3x3_dw(x, torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16))
    # TMA needs 16-byte aligned tensors: a view one element in is refused
    flat = torch.zeros(1 + x.numel(), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cv.conv3x3_valid_fwd(flat[1:].view(x.shape), k)


def test_sincos_kernel_within_two_ulps_of_float64(dev):
    from crnerf_tpu_torch.ops import sincos as sc

    x01 = torch.rand(1024, 128, generator=torch.Generator().manual_seed(7))
    for scale in sc.SCALES:
        x = (x01 * 2 - 1) * scale
        s, c = sc.sincos(x.to(dev))
        x64 = x.double()
        assert float((s.cpu().double() - torch.sin(x64)).abs().max()) \
            <= sc.F64_TOL
        assert float((c.cpu().double() - torch.cos(x64)).abs().max()) \
            <= sc.F64_TOL


# ------------------------------------- the pipelined render and the stores
@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("depth,width,c,n,s", [
    (6, 64, 16, 37, 100), (8, 256, 64, 64, 128), (2, 48, 24, 9, 130),
])
def test_pipe_render_gives_k1_bits(dev, p, depth, width, c, n, s):
    """S2 against K1 on the same inputs: the same bits, for every rays a
    CTA (p = 3 leaves a ragged last CTA), S with a partial
    last chunk, padded widths; and against the plain version within K1's
    bf16 tolerance. K1 is the variant of S2's own kernel (pipe_variant:
    the wgmma ones at the served widths), whose code S2 shares."""
    from crnerf_tpu_torch.ops import pipe_render as pr

    torch.manual_seed(3)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, noise = _inputs(dev, n, s)
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    variant = pr.pipe_variant(kw.dims)
    key = "pipe_render_fwd" + ("" if variant == "wgmma" else "_mma")
    before = pr.LAUNCH_COUNTS[key]
    blk, w = pr.pipe_render_apply(kw, o, d, z, noise, False, p)
    blk1, w1, _ = fr.render_fwd(kw, o, d, z, noise, False, stash=False,
                                variant=variant)
    torch.cuda.synchronize()
    assert pr.LAUNCH_COUNTS[key] == before + 1
    assert torch.equal(blk, blk1) and torch.equal(w, w1)
    blk_p, w_p = pr.pipe_render_plain(params, o, d, z, noise, 15, 4,
                                      torch.bfloat16, False)
    tw, tf, td = fr.KERNEL_TOL[torch.bfloat16]
    assert float((w - w_p).abs().max()) <= tw
    assert float((blk[:, :c] - blk_p[:, :c]).abs().max()) <= tf
    assert float((blk[:, c] - blk_p[:, c]).abs().max()) <= td


def test_pipe_render_refuses_what_the_kernel_does_not_take(dev):
    from crnerf_tpu_torch.ops import pipe_render as pr

    params = fr.mlp_params_from_module(
        NerfMLP(depth=2, width=32, out_dim=8).to(dev))
    o, d, z, noise = _inputs(dev, 4, 16)
    with pytest.raises(ValueError, match="bf16 only"):
        pr.pipe_render_apply(fr.prepare_kernel_weights(params), o, d, z,
                             noise)
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    assert pr.pipe_render_occupancy(kw, dev) >= 1
    with pytest.raises(ValueError, match="on cpu"):
        pr.pipe_render_apply(kw, o.cpu(), d, z, noise)


@pytest.mark.parametrize("mode", ["base", "stores", "dmatrix"])
@pytest.mark.parametrize("tiles", [1, 37])
def test_sublane_stores_kernel_matches_plain(dev, mode, tiles):
    """S5 against its plain version on real (sin, cos) states: the outputs
    within the mode's ops.sublane_stores.KERNEL_TOL of the largest value,
    the bf16 blocks (read back through w = [I | 0]) within its BLOCK_TOL
    (the same bits in base and stores), and the rows it zeroes: a w that
    is zero outside them gives an exactly zero output."""
    from crnerf_tpu_torch.ops import sublane_stores as ss
    from crnerf_tpu_torch.tools.spike_sublane_stores import (
        real_states,
        spike_inputs,
    )

    x = real_states(tiles, dev)
    w = spike_inputs(1, dev)[1]
    before = ss.LAUNCH_COUNTS["sublane_stores"]
    got = ss.sublane_stores(x, w, mode)
    torch.cuda.synchronize()
    assert ss.LAUNCH_COUNTS["sublane_stores"] == before + 1
    want = ss.sublane_stores_plain(x, w, mode)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) \
        <= ss.KERNEL_TOL[mode] * float(want.abs().max())
    blk_want = ss.sublane_blocks_plain(x, mode).to(torch.bfloat16).float()
    assert float((ss.kernel_blocks(x, mode) - blk_want).abs().max()) \
        <= ss.BLOCK_TOL[mode]
    rows = {"base": range(8, 96), "stores": range(93, 96)}.get(mode)
    if rows:
        w_zero = torch.zeros_like(w)
        w_zero[list(rows)] = w[list(rows)]
        assert not bool(ss.sublane_stores(x, w_zero, mode).any())


def test_cgnet_is_ieee_fp32_at_a_users_tf32_flags(dev):
    """With TF32 allowed in cuDNN, as PyTorch's default has it, CGNet's
    mask and parameter gradients are the bits of the same evaluation with
    TF32 off: its convolutions are pinned to IEEE fp32."""
    from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
    from crnerf_tpu_torch.tools.tf32_ab import cgnet_eval, no_tf32

    torch.manual_seed(4)
    net = ContextGuidedNetwork().to(dev)
    x = torch.rand(4, 160, 224, 3, generator=torch.Generator().manual_seed(
        8)).to(dev)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        mask, grads = cgnet_eval(net, x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    with no_tf32():
        ref_mask, ref_grads = cgnet_eval(net, x)
    assert torch.equal(mask, ref_mask)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
