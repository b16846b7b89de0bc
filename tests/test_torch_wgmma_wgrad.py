"""The host side of K2's wgmma weight gradient and of the ping-pong S2
(crnerf_tpu_torch.ops.fused_render, ops.fused_mlp, ops.pipe_render): the
kernel each shape takes, the tile table and the splits of the points, the
slabs of the recompute and per-point backwards that run it, and the
refusals. The plan is also played on the CPU (each tile a 128-row box of
the stash against the job's whole dz width, the splits summed in index
order) and held to ``bwd_wgrad_plain``, which tests/test_torch_wgmma_train.py
and tests/test_torch_train_kernels.py hold to the JAX package's stash
backward. The kernels themselves run on the card only (chip_smoke.py phase
4)."""

import numpy as np
import pytest
import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.ops import pipe_render as pr

SMS = 132   # an H100 SXM's SMs


def _kw(dt=torch.bfloat16, width=256, c=64, depth=8):
    torch.manual_seed(0)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c))
    return fr.prepare_kernel_weights(params, 15, 4, dt)


@pytest.fixture(scope="module")
def served():
    return _kw()


@pytest.mark.parametrize("dt,width,c,want", [
    (torch.bfloat16, 256, 64, "wgmma"),
    (torch.bfloat16, 128, 64, "mma"),
    (torch.bfloat16, 256, 32, "mma"),
    (torch.float32, 256, 64, "fp32"),
])
def test_wgrad_variant_by_dtype_and_width(dt, width, c, want):
    kw = _kw(dt, width, c, depth=2)
    assert fr.wgrad_variant(kw.dims) == want
    # S2 takes K1's choice; its card path is bf16 only
    assert pr.pipe_variant(kw.dims) == (
        "wgmma" if want == "wgmma" else "mma")


@pytest.mark.parametrize("layout", ["render", "mlp"])
def test_wgmma_tile_table_covers_every_gradient_once(served, layout):
    """128-row tiles of each job's whole dz width: every output exactly
    once, at most 256 columns (the widest product), the two row halves of
    a job next to each other, every box inside the stash and dz rows."""
    lay = (fr.grad_layout(served.dims) if layout == "render"
           else fm.mlp_grad_layout(served.dims))
    tab = fr._tile_table(lay, 128, "cpu", fr.MAX_WIDTH).numpy()
    assert len(tab) == sum(-(-k // 128) for _, _, k, _, _, _ in lay.jobs)
    seen = np.zeros(lay.wt, np.int32)
    for a_col, kv, b_col, nv, off, ld in tab:
        assert 0 < kv <= 128 and 0 < nv <= fr.MAX_WIDTH and nv == ld
        assert a_col + kv <= lay.sc and b_col + nv <= lay.dc
        assert a_col < lay.sc and b_col + 64 * -(-nv // 64) <= lay.dc
        idx = off + np.arange(kv)[:, None] * ld + np.arange(nv)[None]
        seen[idx.reshape(-1)] += 1
    assert np.all(seen == 1)
    # job by job, a job's row blocks side by side (they read one dz block)
    order = [(a_col + tm, b_col, off + tm * n)
             for _, a_col, k, b_col, n, off in lay.jobs
             for tm in range(0, k, 128)]
    assert [tuple(r) for r in tab[:, [0, 2, 4]].tolist()] == order


@pytest.mark.parametrize("layout", ["render", "mlp"])
def test_pair_table_for_clusters_of_two(served, layout):
    """The kernel's table: the same tiles, each exactly once, in pairs
    (rows 2i, 2i + 1 a cluster): a job's two 128-row halves together (the
    same dz columns: one load for both), then the one-tile jobs two by
    two, an odd one beside a row of zeros; an even count."""
    lay = (fr.grad_layout(served.dims) if layout == "render"
           else fm.mlp_grad_layout(served.dims))
    tiles = fr._tile_table(lay, 128, "cpu", fr.MAX_WIDTH).tolist()
    pairs = fr._pair_table(lay, "cpu").tolist()
    busy = [r for r in pairs if r[1] > 0]
    assert len(pairs) % 2 == 0 and sorted(busy) == sorted(tiles)
    assert all(r == [0] * 6 for r in pairs if r[1] == 0)
    assert len(pairs) - len(busy) <= 1
    two = {(a, b) for _, a, k, b, _, _ in lay.jobs if k > 128}
    shared = 0
    for t0, t1 in zip(pairs[0::2], pairs[1::2]):
        if (t0[0] - 0, t0[2]) in two or (t0[0] - 128, t0[2]) in two:
            assert t1[2] == t0[2] and t1[3] == t0[3]
            assert t1[0] == t0[0] + 128
            shared += 1
    assert shared == len(two)


def test_wgrad_ab_unshared_table(served):
    """tools/wgrad_ab's table with the clusters' multicast off: the same
    tiles, each once, no cluster whose two tiles read one stash or dz
    block."""
    from crnerf_tpu_torch.tools.wgrad_ab import unshared_pairs

    pairs = fr._pair_table(fr.grad_layout(served.dims), "cpu")
    got = unshared_pairs(pairs).tolist()
    assert sorted(got) == sorted(pairs.tolist())
    for t0, t1 in zip(got[0::2], got[1::2]):
        if t0[1] and t1[1]:
            assert t0[0] != t1[0] and t0[2] != t1[2]


@pytest.mark.parametrize("m", [1, 63, 64, 1000, 5000, 202_752, 1_048_576,
                               2_097_152])
@pytest.mark.parametrize("n_tiles", [23, 22])
def test_wgmma_splits_cover_the_points(m, n_tiles):
    """Splits x points a split cover m, a split is whole 64-point steps,
    no more than WGRAD_WAVES waves of (tile, split) items on the SMs, and
    at the main shapes nearly that many (the last wave nearly full)."""
    splits = fr.wgrad_splits("wgmma", n_tiles, m, SMS)
    m_per = fr._round_up(-(-m // splits), 64)
    assert splits * m_per >= m and m_per % 64 == 0
    assert (splits - 1) * m_per < m                 # no empty split
    assert n_tiles * splits <= fr.WGRAD_WAVES * SMS
    if splits > 1:
        assert m_per >= fr.WGRAD_MIN_STEPS * 64 - 63
    if m >= 202_752:
        assert n_tiles * splits > (fr.WGRAD_WAVES - 1) * SMS


@pytest.mark.parametrize("s", [64, 128])
def test_slab_plans_of_the_recompute_and_per_point_backwards(served, s):
    """K3's and K4-bwd's slabs at the train step's passes (16,384 rays):
    every slab, the last one shorter, is covered by the weight gradient's
    plan for a full slab, and the slabs cover the pass."""
    n = 16_384
    r = fr.slab_rays_for(served, n, s)
    mkw = fm.prepare_mlp_weights(served.params, 15, 4, torch.bfloat16)
    p = fm.slab_points_for(mkw, n * s)
    for pts, total in ((r * s, n * s), (p, n * s)):
        splits = fr.wgrad_splits("wgmma", 23, pts, SMS)
        m_per = fr._round_up(-(-pts // splits), 64)
        slabs = [min(pts, total - p0) for p0 in range(0, total, pts)]
        assert sum(slabs) == total
        assert all(0 < q <= splits * m_per for q in slabs)


def _play_wgmma_plan(lay, st, dz, sms):
    """The wgmma kernel's plan on the CPU: per (split, tile) a partial of
    128 stash columns (zero past the row) against the job's whole dz
    width, stored where the row and column are the job's; the splits
    summed in index order."""
    m = st.shape[0]
    tab = fr._pair_table(lay, "cpu").tolist()
    splits = fr.wgrad_splits("wgmma", len(tab), m, sms)
    m_per = fr._round_up(-(-m // splits), 64)
    stp = torch.cat([st.float(), st.new_zeros(m, 128).float()], 1)
    dzp = torch.cat([dz.float(), dz.new_zeros(m, 256).float()], 1)
    part = torch.full((splits, lay.wt), float("nan"))
    for sp in range(splits):
        rows = slice(sp * m_per, min(m, (sp + 1) * m_per))
        for a_col, kv, b_col, nv, off, ld in tab:
            if kv == 0:
                continue
            n_box = 64 * -(-nv // 64)
            blk = stp[rows, a_col:a_col + 128].T @ dzp[rows, b_col:b_col
                                                       + n_box]
            out = part[sp, off:off + kv * ld].view(kv, ld)
            out[:, :nv] = blk[:kv, :nv]
    gw = torch.zeros(lay.wt)
    for sp in range(splits):
        gw = gw + part[sp]
    return gw, splits


@pytest.mark.parametrize("layout", ["render", "mlp"])
def test_played_plan_matches_plain(served, layout):
    """The plan (the pair table) at 3,000 points on a card of 36 SMs (three
    splits, a short last one) against bwd_wgrad_plain: fp32 sums in another
    order."""
    lay = (fr.grad_layout(served.dims) if layout == "render"
           else fm.mlp_grad_layout(served.dims))
    g = torch.Generator().manual_seed(1)
    st = torch.randn(3000, lay.sc, generator=g).to(torch.bfloat16)
    dz = torch.randn(3000, lay.dc, generator=g).to(torch.bfloat16)
    got, splits = _play_wgmma_plan(lay, st, dz, sms=36)
    want = fr.bwd_wgrad_plain(served, st, dz, lay)
    assert splits == 3 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_refusals(served):
    """A weight-gradient kernel named where the shape does not take it:
    ValueError before any device is touched (S2 names no kernel: it takes
    pipe_variant's, and the card refuses fp32)."""
    lay = fr.grad_layout(served.dims)
    st = torch.zeros(8, lay.sc, dtype=torch.bfloat16)
    dz = torch.zeros(8, lay.dc, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight gradient takes"):
        fr.bwd_wgrad(served, st, dz, variant="fp32")
    narrow = _kw(width=128, depth=2)
    lay_n = fr.grad_layout(narrow.dims)
    with pytest.raises(ValueError, match="weight gradient takes"):
        fr.bwd_wgrad(narrow, st.new_zeros(8, lay_n.sc),
                     dz.new_zeros(8, lay_n.dc), variant="wgmma")
    fp32 = _kw(torch.float32, depth=2)
    lay_f = fr.grad_layout(fp32.dims)
    with pytest.raises(ValueError, match="weight gradient takes"):
        fr.bwd_wgrad(fp32, torch.zeros(8, lay_f.sc), torch.zeros(8, lay_f.dc),
                     variant="mma")
    with pytest.raises(ValueError, match="weight gradient takes"):
        fr.bwd_wgrad(served, st, dz, variant="tc")


def test_slab_entries_name_the_weight_gradient_kernel():
    """The recompute and per-point backward entries end their dims with
    the weight gradient's kernel, its number as the C entry takes it."""
    assert fr._RECOMPUTE_DIMS[-1] == "WK" and fm._BWD_DIMS[-1] == "WK"
    assert fr._WGRAD_DIMS[-1] == "WK"
    assert fr._WGRAD_KERNEL == {"fp32": 0, "mma": 1, "wgmma": 2}
