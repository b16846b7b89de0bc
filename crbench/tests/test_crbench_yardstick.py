"""The frozen yardstick against the numbers PERF.md reads and against hand
arithmetic from the configurations' widths."""

import pytest

from crbench.harness import load_json
from crbench.yardstick import (
    Mlp,
    frame_flops,
    render_fwd_bound,
    step_flops,
    train_pass_bounds,
)

# 8x256 trunk over the 93-wide encode, the skip at layer 4 (349 in), the
# sigma head, the final layer, the dir layer (256 + 27 -> 128), the
# feature head (128 -> 64): products of one point, the dir-encode rows
# shared by the s points of a ray
TRUNK = 93 * 256 + 3 * 256 * 256 + 349 * 256 + 3 * 256 * 256
MATS = TRUNK + 256 + 256 * 256 + 256 * 128 + 128 * 64


def fwd(s):
    return 2 * (MATS + 27 * 128 / s)


def test_mlp_products_per_point():
    assert MATS == 613120
    from crbench.yardstick import mlp_work
    assert mlp_work(Mlp(), 128)[0] == fwd(128)


def test_k1_bound_at_16384_x_128():
    ms, by = render_fwd_bound(Mlp(), 16384, 128)
    assert (round(ms, 3), by) == (2.600, "operations")
    ms, by = render_fwd_bound(Mlp(), 8192, 512)
    assert (round(ms, 3), by) == (5.200, "operations")


def test_stash_route_bounds_at_16384_x_128():
    b = train_pass_bounds(Mlp(), 16384, 128)
    assert {k: (round(v[0], 3), v[1]) for k, v in b.items()} == {
        "fwd_stash": (3.165, "bytes"), "chain": (5.890, "bytes"),
        "wgrad": (6.331, "bytes")}


def enc_a(h, w, c=64):
    """enc_a's forward FLOP on an h x w image, layer by layer."""
    p, p2, p4 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    return 2 * (p * 3 * 3 + p * 64 * 3 * 9 + p * 64 * 64 * 9
                + p2 * 128 * 64 * 9 + p2 * 128 * 128 * 9
                + p4 * 128 * 128 * 9 + 32 * 32 * c * 128)


def cgnet(h, w):
    """CGNet's forward FLOP (M = N = 2) on an h x w image."""
    a = (h // 2) * (w // 2)       # even sizes: the strided convs halve
    b, c = a // 4, a // 16
    lvl1 = a * 32 * 3 * 9 + 2 * a * 32 * 32 * 9
    lvl2 = (b * 64 * 35 * 9 + 2 * b * 64 * 9 + b * 64 * 128
            + 2 * 64 * 8 + b * 32 * 64 + 2 * b * 32 * 9 + 2 * 64 * 8)
    lvl3 = (c * 128 * 131 * 9 + 2 * c * 128 * 9 + c * 128 * 256
            + 2 * 128 * 8 + c * 64 * 128 + 2 * c * 64 * 9 + 2 * 128 * 8)
    return 2 * (lvl1 + lvl2 + lvl3 + c * 256)


def style(p, styled=True):
    """StyleNet's forward FLOP on a map of p pixels, C = 64, m = 32."""
    dec = 2 * p * 64 * 3
    if not styled:
        return dec

    def gram(q):
        return 2 * q * (64 * 128 + 128 * 64 + 64 * 32) + 2 * q * 32 * 32 \
            + 2 * 1024 * 1024

    return (2 * p * 64 * 32 + gram(p) + gram(1024) + 2 * 32 ** 3
            + 2 * p * 32 * 32 + 2 * p * 32 * 64 + dec)


def test_step_flops_by_hand():
    f = load_json("configs", "crnerf_gate_train.json")["fields"]
    assert f["grids_per_step"] == 1
    mlp = 3 * 1024 * (64 * fwd(64) + 128 * fwd(128))
    per_grid = (enc_a(160, 224) + cgnet(160, 224) + enc_a(32, 32)
                + 3 * style(1024) + 2 * enc_a(32, 32) + style(1024, False))
    assert step_flops(f) == pytest.approx(mlp + 3 * per_grid, rel=1e-12)
    assert 11.5e12 / 16 < mlp < 11.7e12 / 16


def test_frame_flops_by_hand():
    f = load_json("configs", "crnerf_gate_render.json")["fields"]
    mlp = 320 * 240 * (256 * fwd(256) + 512 * fwd(512))
    want = mlp + enc_a(160, 224) + 2 * style(320 * 240)
    assert frame_flops(f, (320, 240)) == pytest.approx(want, rel=1e-12)
    assert 72.0e12 < mlp < 72.6e12
