"""The conv spikes' plain versions and packing helpers
(crnerf_tpu_torch/ops/conv.py) on CPU tensors, where the wrappers take the
plain versions, against the JAX spike kernels run on the CPU:
``conv3x3_valid_fwd`` and ``conv3x3_dw`` (scripts/spike_conv3x3.py) with
``interpret=True``, ``pallas_packed_conv`` (scripts/spike_packed_conv.py)
under ``force_tpu_interpret_mode``, and the packing helpers of
crnerf_tpu/models/common.py. ``scripts/`` is no package, so the spikes are
loaded by file path. Shapes are small and inputs come from a numpy seed.
The JAX kernels need H % r_tile == 0 (the forward leaves the remaining
rows unwritten); ragged shapes are held to XLA's convolution instead."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from crnerf_tpu.models import common as jc
from crnerf_tpu_torch.ops import conv as cv
from crnerf_tpu_torch.ops import sincos as sc

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Plain version against the JAX kernels at fp32: the same products summed
# in another order (by tap and tile there, by one matmul a tap here), over
# 9 * C terms an output (or all pixels for the gradient); measured up to
# 4.9e-7 of the largest value (the gradient; the packed conv gives the same
# bits), bound 1e-5. Against XLA's convolution the same.
TOL_F32 = 1e-5
# bf16 outputs (the packed conv at bf16): one bf16 step of the largest
# value on top, since two fp32 sums a hair apart can round to neighbours.
TOL_BF16 = 2.0 ** -7 + TOL_F32


def _spike(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spike3():
    return _spike("spike_conv3x3")


@pytest.fixture(scope="module")
def spike_packed():
    return _spike("spike_packed_conv")


def _normal(shape, seed, bf16=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if bf16:  # bf16-valued: rounded once, then both sides see these values
        a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _xla_conv(x, k):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


# ------------------------------------------------------ packing helpers
@pytest.mark.parametrize("name,shape", [
    ("_s2d", (2, 8, 12, 5)), ("_d2s", (2, 4, 6, 12)),
    ("_pack_kernel3x3", (3, 3, 5, 7)), ("packed_reflect_pad1", (2, 4, 6, 12)),
    ("reflect_pad", (2, 7, 9, 3)),
])
def test_packing_helpers_bit_equal(name, shape):
    """Slices, reshapes and an einsum with one non-zero term an entry: the
    port's helper gives the JAX helper's bits at fp32."""
    x = _normal(shape, 0)
    want = np.asarray(getattr(jc, name)(jnp.asarray(x)))
    got = getattr(cv, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_s2d_assembly_equal():
    np.testing.assert_array_equal(cv._s2d_assembly().numpy(),
                                  jc._s2d_assembly())


# --------------------------------------------------- S1: 3x3 conv, grad
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 16, 24, 8, 16), (1, 8, 8, 16, 8)])
def test_plain_fwd_matches_spike_kernel(spike3, bf16, n, h, w, c, co):
    """The plain forward against conv3x3_valid_fwd in interpret mode, at
    fp32 and at bf16 (bf16 arrays on both sides), H % 8 == 0."""
    xpad = _normal((n, h + 2, w + 2, c), 1, bf16)
    k = _normal((3, 3, c, co), 2, bf16)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = spike3.conv3x3_valid_fwd(jnp.asarray(xpad, dt),
                                    jnp.asarray(k, dt), interpret=True)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = cv.conv3x3_valid_fwd(torch.from_numpy(xpad).to(tdt),
                               torch.from_numpy(k).to(tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert tuple(got.shape) == (n, h, w, co)
    assert _rel(got.numpy(), want) <= TOL_F32


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_dw_matches_spike_kernel(spike3, bf16):
    n, h, w, c, co = 2, 16, 24, 8, 16
    xpad = _normal((n, h + 2, w + 2, c), 3, bf16)
    dy = _normal((n, h, w, co), 4, bf16)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = spike3.conv3x3_dw(jnp.asarray(xpad, dt), jnp.asarray(dy, dt),
                             interpret=True)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = cv.conv3x3_dw(torch.from_numpy(xpad).to(tdt),
                        torch.from_numpy(dy).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, c, co)
    assert _rel(got.numpy(), want) <= TOL_F32


@pytest.mark.parametrize("n,h,w,c,co", [(2, 13, 19, 5, 7), (1, 1, 3, 3, 2)])
def test_ragged_against_xla(n, h, w, c, co):
    """H not a multiple of any row tile (the JAX kernels cannot run it):
    forward against XLA's conv, gradient against jax.grad of it."""
    xpad = _normal((n, h + 2, w + 2, c), 5)
    k = _normal((3, 3, c, co), 6)
    dy = _normal((n, h, w, co), 7)
    want = _xla_conv(xpad, k)
    got = cv.conv3x3_valid_fwd(torch.from_numpy(xpad), torch.from_numpy(k))
    assert _rel(got.numpy(), want) <= TOL_F32
    g = jax.grad(lambda kk: jnp.sum(_xla_conv(xpad, kk) * dy))(
        jnp.asarray(k))
    got_dw = cv.conv3x3_dw(torch.from_numpy(xpad), torch.from_numpy(dy))
    assert _rel(got_dw.numpy(), g) <= TOL_F32


# ---------------------------------------------------------- S4: packed
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_packed_matches_spike_kernel(spike_packed, bf16):
    """The plain packed conv against pallas_packed_conv (rt = 8, I = 8) on
    the packed, pre-padded input of a (2, 16, 24, 8) image; out in the
    input's dtype on both sides."""
    x = _normal((2, 16, 24, 8), 8, bf16)
    k3 = _normal((3, 3, 8, 16), 9, bf16) * 0.05
    dt = jnp.bfloat16 if bf16 else jnp.float32
    xp_pad = jc.packed_reflect_pad1(jc._s2d(jnp.asarray(x, dt)))
    k2 = jc._pack_kernel3x3(jnp.asarray(k3, dt))
    with pltpu.force_tpu_interpret_mode():
        want = spike_packed.pallas_packed_conv(xp_pad, k2, 8)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = cv.packed_conv(
        torch.from_numpy(np.asarray(xp_pad.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.asarray(k2.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 8, 12, 64)
    assert _rel(got.float().numpy(), want) <= (TOL_BF16 if bf16
                                               else TOL_F32)


@pytest.mark.parametrize("shape,f", [((2, 16, 24, 8), 16),
                                     ((1, 26, 14, 3), 5)])
def test_packed_conv_is_the_3x3_reflect_conv(shape, f):
    """_d2s of the packed conv of the packed input is the 3x3 conv of the
    reflect-padded original (the tie chip_smoke.py checks on the card),
    here also at a ragged I = 13 against XLA's packed conv."""
    x = torch.from_numpy(_normal(shape, 10))
    k3 = torch.from_numpy(_normal((3, 3, shape[-1], f), 11))
    xp_pad = cv.packed_reflect_pad1(cv._s2d(x))
    k2 = cv._pack_kernel3x3(k3)
    packed = cv.packed_conv(xp_pad, k2)
    want = cv.conv3x3_valid_fwd(cv.reflect_pad(x, 1), k3)
    assert _rel(cv._d2s(packed).numpy(), want.numpy()) <= TOL_F32
    assert _rel(packed.numpy(), _xla_conv(xp_pad.numpy(), k2.numpy())) \
        <= TOL_F32


# ------------------------------------------------------------- wrappers
def test_cpu_tensors_leave_the_launch_counters_at_zero():
    before = {**cv.LAUNCH_COUNTS, **sc.LAUNCH_COUNTS}
    x = torch.from_numpy(_normal((1, 6, 8, 8), 12)).to(torch.bfloat16)
    k = torch.from_numpy(_normal((3, 3, 8, 8), 13)).to(torch.bfloat16)
    cv.conv3x3_valid_fwd(x, k)
    cv.conv3x3_dw(x, torch.zeros(1, 4, 6, 8, dtype=torch.bfloat16))
    cv.packed_conv(x[:, :3, :5], k[:2, :2])
    sc.sincos(torch.zeros(4, 4), fast=True)
    assert {**cv.LAUNCH_COUNTS, **sc.LAUNCH_COUNTS} == before
    assert all(v == 0 for v in before.values())


@pytest.mark.parametrize("fn", ["conv3x3_valid_fwd", "conv3x3_dw",
                                "packed_conv"])
def test_wrappers_raise_on_another_device(fn):
    """Neither the CPU's plain version nor a launch: a device that is
    neither CPU nor CUDA is refused."""
    x = torch.empty(1, 4, 4, 8, device="meta", dtype=torch.bfloat16)
    other = torch.empty(2, 2, 8, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="device"):
        getattr(cv, fn)(x, other)


@pytest.mark.parametrize("m,tiles", [(286_720, 9), (573_440, 9), (1, 9),
                                     (100, 1), (65, 72), (12_345, 36)])
def test_dw_split_covers_every_pixel_once(m, tiles):
    """Slices of the mma.sync gradient kernel: whole 64-pixel stages, none
    empty, their union exactly [0, m); about 528 blocks where m allows."""
    splits, m_per = cv.dw_split(m, tiles)
    assert m_per % 64 == 0 and 1 <= splits <= 65535
    assert (splits - 1) * m_per < m <= splits * m_per
    assert splits * tiles <= 528 + tiles


# ------------------------------------------- the wgmma variants' host side
@pytest.mark.parametrize("c,co,want", [
    (64, 64, "wgmma"), (256, 256, "wgmma"), (512, 512, "wgmma"),
    (40, 72, "wgmma"), (40, 24, "wgmma"), (8, 8, "wgmma"),
    (13, 21, "mma"), (12, 20, "mma"), (64, 60, "mma"), (4, 64, "mma"),
])
def test_conv_variant_by_shape(c, co, want):
    """TMA needs every row 16-byte aligned: C and Co multiples of 8 take
    the wgmma kernels, any other shape the mma.sync ones. The spikes' main
    shapes (S1 64 -> 64, S4 4C = 256 and 512) take wgmma."""
    assert cv.conv_variant(c, co) == want


@pytest.mark.parametrize("h,w,taps,want", [
    (160, 224, 3, (8, 16)),      # S1, enc_a's conv3: no padded pixel
    (80, 112, 2, (8, 16)),       # S4 conv3 level
    (40, 56, 2, (16, 8)),        # S4 conv5 level
    (37, 53, 3, None), (19, 23, 3, None), (1, 1, 3, None),
    (13, 19, 2, None), (11, 14, 2, None), (300, 7, 3, None),
])
def test_conv_tile_is_the_least_padded_that_fits(h, w, taps, want):
    """BW x BH = 128 pixels, BW a multiple of 8 (a tap row's shift stays on
    whole swizzle atoms), the input box (BH + taps - 1 rows of BW pixels,
    128 bytes each) within one 24 KB slot, and no other such tile pads
    fewer pixels (ties: the smaller box)."""
    bw, bh = cv.conv_tile(h, w, taps)
    assert bw * bh == 128 and bw % 8 == 0
    assert (bh + taps - 1) * bw * 128 <= 24576

    def key(bw_, bh_):
        return (-(-h // bh_) * bh_ * (-(-w // bw_) * bw_),
                (bh_ + taps - 1) * bw_)

    fits = [(b, 128 // b) for b in (8, 16, 32, 64, 128)
            if (128 // b + taps - 1) * b <= 192]
    assert key(bw, bh) == min(key(*t) for t in fits)
    if want is not None:
        assert (bw, bh) == want


@pytest.mark.parametrize("tiles,blocks", [
    (4480, 1), (2240, 1), (1, 1), (131, 1), (133, 1), (10, 2), (7, 4),
    (1000, 64), (1000, 200), (97, 3),
])
def test_dw_slices_cover_every_tile_once(tiles, blocks):
    """Slices of the wgmma gradient kernel, slice s over tiles [s * T // S,
    (s + 1) * T // S) as the kernel takes them: none empty, their union
    exactly [0, T), at most one tile apart in size; 132 CTAs (one an SM)
    where the tiles allow, at least one slice a 64 x 64 block."""
    slices = cv.dw_slices(tiles, blocks)
    assert 1 <= slices <= tiles
    bounds = [s * tiles // slices for s in range(slices + 1)]
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert slices == max(1, min(tiles, 132 // blocks))


@pytest.mark.parametrize("n,h,w", [(16, 160, 224), (3, 37, 53), (1, 1, 1)])
def test_dw_slices_give_the_same_plan_for_the_same_shape(n, h, w):
    """The gradient's bits depend on the plan alone, and the plan on the
    shapes alone: two calls agree, and every pixel tile of the image lies
    in exactly one slice."""
    bw, bh = cv.conv_tile(h, w, 3)
    tiles = n * -(-h // bh) * -(-w // bw)
    slices = cv.dw_slices(tiles, 1)
    assert cv.dw_slices(tiles, 1) == slices
    owner = [next(s for s in range(slices)
                  if s * tiles // slices <= t < (s + 1) * tiles // slices)
             for t in range(tiles)]
    assert sorted(set(owner)) == list(range(slices))
