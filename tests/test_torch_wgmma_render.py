"""The host side of the fused render forward's two kernels
(crnerf_tpu_torch/ops/fused_render.py) on the CPU: the wgmma kernel's
weight stream unpacks to the padded matrices bit for bit and is packed at
its first use only, the variant is chosen by dtype and width, the
no-stash training forward asks for the recompute's variant and the stash
forward goes by shape, both variants give the plain version
on CPU tensors and launch nothing; and the sincos wrapper's bound entry
point (ops/_build.py ``entry``)."""

import numpy as np
import pytest
import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import _build
from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.ops import sincos as sc


def _params(depth, width, c, seed=0):
    torch.manual_seed(seed)
    return fr.mlp_params_from_module(NerfMLP(depth=depth, width=width,
                                             out_dim=c))


def _unpack(packed, k, n):
    """pack_wgmma_b's inverse, written out: slice kc, row n, chunk q' holds
    B[64 kc + 8 (q' ^ n % 8) + e, n]."""
    p = packed.reshape(k // 64, n, 8, 8).float()
    out = torch.empty((k, n))
    for kc in range(k // 64):
        for row in range(n):
            for qs in range(8):
                q = qs ^ (row % 8)
                out[64 * kc + 8 * q:64 * kc + 8 * q + 8, row] = p[kc, row, qs]
    return out


def _stream_matrices(kw):
    """The stream cut back into its (K, N) matrices, in its order."""
    d, pad = kw.dims, kw.padded
    shapes = []
    for i in range(d["L"]):
        if ("wenc", i) in pad:
            shapes.append((("wenc", i), fr.WGMMA_KE, d["WP"]))
        if ("wh", i) in pad:
            shapes.append((("wh", i), d["WP"], d["WP"]))
    shapes += [("ws", d["WP"], fr.WGMMA_SIGMA_N), ("wf", d["WP"], d["WP"]),
               ("wdh", d["WP"], d["HP"]), ("wc", d["HP"], d["CP"])]
    stream = fr.wgmma_weights(kw)
    off, out = 0, {}
    for key, k, n in shapes:
        out[key] = _unpack(stream[off:off + k * n], k, n)
        off += k * n
    assert off == stream.numel()
    return out


@pytest.mark.parametrize("depth,width,c,dims", [
    (8, 256, 64, dict(KE=96, WP=256, HP=128, CP=64)),
    (5, 240, 40, dict(KE=96, WP=256, HP=128, CP=64)),  # ragged widths
])
def test_wgmma_stream_unpacks_to_the_padded_matrices(depth, width, c, dims):
    kw = fr.prepare_kernel_weights(_params(depth, width, c), 15, 4,
                                   torch.bfloat16)
    assert {k: kw.dims[k] for k in dims} == dims
    assert kw.derived == {}     # nothing is packed before its first use
    assert fr.wgmma_weights(kw).dtype == torch.bfloat16
    assert fr.wgmma_weights(kw) is kw.derived["wgmma"]   # packed once
    for key, got in _stream_matrices(kw).items():
        want = kw.padded[key].to(torch.bfloat16).float()
        if key == "ws":
            want = want[:, :fr.WGMMA_SIGMA_N]
        assert torch.equal(got[:want.shape[0]], want), key
        # the encode rows past KE are zero
        assert not got[want.shape[0]:].any(), key


def test_pack_wgmma_b_swizzles_chunks_by_row():
    b = torch.arange(128 * 16, dtype=torch.float32).reshape(128, 16)
    p = fr.pack_wgmma_b(b)
    assert p.shape == (2, 16, 64) and p.dtype == b.dtype
    # row n of slice kc: its 16-byte chunk q' holds chunk q' ^ (n % 8)
    for kc, n, qs in ((0, 0, 0), (0, 3, 1), (1, 13, 6), (1, 7, 7)):
        q = qs ^ (n % 8)
        want = b[64 * kc + 8 * q:64 * kc + 8 * q + 8, n]
        assert torch.equal(p[kc, n, 8 * qs:8 * qs + 8], want)
    assert torch.equal(_unpack(p, 128, 16), b)


@pytest.mark.parametrize("depth,width,c,dt,n_emb,stash,want", [
    (8, 256, 64, torch.bfloat16, 15, False, "wgmma"),   # the served MLPs
    (8, 256, 128, torch.bfloat16, 15, False, "mma"),    # CP 128
    (3, 128, 64, torch.bfloat16, 15, False, "mma"),     # WP 128
    (3, 240, 40, torch.bfloat16, 15, False, "wgmma"),   # pads to 256 / 64
    (8, 256, 64, torch.float32, 15, False, "mma"),      # no IEEE fp32 wgmma
    (8, 256, 64, torch.bfloat16, 15, True, "wgmma"),    # the stash form
    (6, 64, 16, torch.bfloat16, 15, False, "mma"),      # WP 64
    (4, 192, 64, torch.bfloat16, 15, False, "mma"),     # WP 192
    (4, 256, 16, torch.bfloat16, 15, False, "mma"),     # CP 32
    (4, 256, 64, torch.bfloat16, 21, False, "mma"),     # 129 encode columns
    (4, 256, 64, torch.bfloat16, 20, False, "wgmma"),   # 123
])
def test_render_variant_by_dtype_and_width(depth, width, c, dt, n_emb, stash,
                                           want):
    p = _params(depth, width, c)
    if n_emb != 15:   # a trunk that takes that encode
        torch.manual_seed(0)
        p = fr.mlp_params_from_module(NerfMLP(
            depth=depth, width=width, out_dim=c,
            in_channels_xyz=3 + 6 * n_emb))
    kw = fr.prepare_kernel_weights(p, n_emb, 4, dt)
    assert fr.render_variant(kw.dims) == want
    if stash:   # the stash form takes the kernel its shape takes
        o, d, z, noise = _rays(2, 4)
        _, _, st = fr.render_fwd(kw, o, d, z, noise, False, stash=True,
                                 variant=want)
        assert st is not None
    assert kw.derived == {}     # the choice packs nothing


def _rays(n, s, seed=1):
    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.normal(0, 0.5, (n, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(0, 1, (n, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.from_numpy(np.sort(g.uniform(0.5, 4.5, (n, s)), -1)
                         .astype(np.float32))
    noise = torch.from_numpy(g.normal(0, 1, (n, s)).astype(np.float32))
    return o, d, z, noise


def test_both_variants_give_the_plain_version_on_cpu_and_launch_nothing():
    p = _params(3, 256, 64)
    kw = fr.prepare_kernel_weights(p, 15, 4, torch.bfloat16)
    o, d, z, noise = _rays(5, 70)
    before = dict(fr.LAUNCH_COUNTS)
    want = fr.render_fwd_plain(p, o, d, z, noise, 15, 4, torch.bfloat16,
                               False)
    for variant in ("wgmma", "mma", None):
        blk, w, st = fr.render_fwd(kw, o, d, z, noise, False, stash=False,
                                   variant=variant)
        assert torch.equal(blk, want[0]) and torch.equal(w, want[1])
        assert st is None
    assert fr.LAUNCH_COUNTS == before
    assert kw.derived == {}     # the plain version needs no stream
    assert {"fused_render_fwd_mma", "fused_render_fwd_xyz_mma"} <= set(before)


def test_render_fwd_refuses_a_variant_the_shape_does_not_take():
    o, d, z, noise = _rays(3, 8)
    kw32 = fr.prepare_kernel_weights(_params(3, 256, 64), 15, 4,
                                     torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(kw32, o, d, z, noise, False, False, variant="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(kw32, o, d, z, noise, False, True, variant="wgmma")
    kw = fr.prepare_kernel_weights(_params(3, 256, 64), 15, 4,
                                   torch.bfloat16)
    with pytest.raises(ValueError, match="'wgmma' or 'mma'"):
        fr.render_fwd(kw, o, d, z, noise, False, False, variant="tma")
    # a width the kernel is not built for
    narrow = fr.prepare_kernel_weights(_params(3, 128, 64), 15, 4,
                                       torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        fr.render_fwd(narrow, o, d, z, noise, False, False, variant="wgmma")
    # unnamed, such a layout takes the mma.sync kernel
    blk, w, _ = fr.render_fwd(narrow, o, d, z, noise, False, False)
    assert torch.isfinite(blk).all() and torch.isfinite(w).all()


@pytest.mark.parametrize("stash", [True, False])
def test_training_forward_asks_for_the_recompute_variant(monkeypatch, stash):
    """fused_render_train's no-stash forward names the recompute's variant
    (recompute_variant: the wgmma kernel at the served widths), whose stash
    form its backward runs again; the stash forward names no kernel and
    takes the wgmma one by shape at the served widths. On CPU tensors
    neither packs a weight stream."""
    seen = []
    real = fr.render_fwd

    def spy(kw, *args, **kwargs):
        seen.append((kw, kwargs.get("variant"), fr.render_variant(kw.dims)))
        return real(kw, *args, **kwargs)

    monkeypatch.setattr(fr, "render_fwd", spy)
    p = _params(3, 256, 64)
    o, d, z, noise = _rays(4, 16)
    out, w = fr.fused_render_train(p, o, d, z, noise,
                                   compute_dtype=torch.bfloat16,
                                   exact_encode=False, stash=stash)
    assert fr.recompute_variant(seen[0][0].dims, 16) == "wgmma"
    assert [(v, r) for _, v, r in seen] == [
        (None if stash else "wgmma", "wgmma")]
    assert seen[0][0].derived == {}
    assert out.shape == (4, 128) and w.shape == (4, 16)


def test_serving_layout_carries_the_stream():
    """The renderer's layouts (CrNerfSystem.kernel_weights) at bf16 and
    the served widths take the wgmma kernel and carry its stream from the
    first launch on, one stream a layout."""
    from crnerf_tpu_torch.config import Config
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(N_samples=8, N_importance=8, netdepth=3, netwidth=256,
                 nerf_out_dim=64, appearance_wh=(64, 48),
                 compute_dtype="bfloat16")
    torch.manual_seed(2)
    kws = CrNerfSystem(cfg).eval().kernel_weights()
    streams = []
    for kw in kws.values():
        assert fr.render_variant(kw.dims) == "wgmma"
        streams.append(fr.wgmma_weights(kw))
        assert fr.wgmma_weights(kw) is streams[-1]
    assert len(streams) == 2 and streams[0] is not streams[1]


def test_build_entry_loads_once_and_then_calls_directly(monkeypatch):
    loads, calls = [], []

    class Lib:
        def crnerf_x(self, *args):
            calls.append(args)
            return 0

    def fake_load(source, argtypes):
        loads.append((source, tuple(argtypes)))
        return Lib()

    monkeypatch.setattr(_build, "load", fake_load)
    fn = _build.entry("x.cu", {"crnerf_x": ()}, "crnerf_x")
    assert loads == []          # nothing is built before the first call
    assert fn(1, 2) == 0 and fn(3) == 0
    assert loads == [("x.cu", ("crnerf_x",))]
    assert calls == [(1, 2), (3,)]


def test_sincos_on_cpu_never_reaches_the_kernel(monkeypatch):
    def no_launch(*args):
        raise AssertionError("the kernel was called for a CPU tensor")

    monkeypatch.setattr(sc, "_launch", no_launch)
    before = dict(sc.LAUNCH_COUNTS)
    x = torch.linspace(-50.0, 50.0, 257)
    s, c = sc.sincos(x)
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))
    # the plain version takes any dtype and layout on the CPU
    xd = x.double()[::2]
    s, c = sc.sincos(xd)
    assert torch.equal(s, torch.sin(xd)) and torch.equal(c, torch.cos(xd))
    assert sc.LAUNCH_COUNTS == before
    with pytest.raises(ValueError, match="device"):
        sc.sincos(torch.empty(4, device="meta"))
