"""The conv spikes' kernels (``csrc/conv_fwd.cuh``, ``csrc/conv.cu``) and
their plain PyTorch versions: counterparts of ``scripts/spike_conv3x3.py``
``conv3x3_valid_fwd`` / ``conv3x3_dw`` and ``scripts/spike_packed_conv.py``
``pallas_packed_conv``, NHWC with the JAX names.

- ``conv3x3_valid_fwd(xpad, kernel)``: VALID 3x3 conv of a pre-padded
  (N, H+2, W+2, C) input with a (3, 3, C, Co) HWIO kernel -> (N, H, W, Co)
  float32;
- ``conv3x3_dw(xpad, dy)``: its kernel gradient (3, 3, C, Co) float32;
- ``packed_conv(xp_pad, k2)``: VALID 2x2 conv of the space-to-depth packed,
  pre-padded (B, I+1, J+1, 4C) input with a (2, 2, 4C, 4F) kernel ->
  (B, I, J, 4F) in the input's dtype.

On the card the operands are bfloat16 (the kernels have no fp32 variant:
fp32 is refused) with fp32 accumulation; any H, W, C and Co. A CPU tensor
takes the plain version, any other device raises. Each kernel has two
variants, chosen here from the shapes before the launch (``conv_variant``):
wgmma with TMA loads when C and Co are multiples of 8, mma.sync with
element-by-element copies otherwise; each counts its launches under its
own name. Below them, the port's
copies of the packing helpers of ``crnerf_tpu/models/common.py:29-116``
that prepare S4's inputs (``_s2d``, ``_d2s``, ``_s2d_assembly``,
``_pack_kernel3x3``, ``packed_reflect_pad1``; ``reflect_pad`` is
``models/common.py``'s). As in the JAX package, no path of the system
calls any of this: the appearance encoder's convolutions are ``nn.Conv2d``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from crnerf_tpu_torch.models.common import reflect_pad  # noqa: F401
from crnerf_tpu_torch.utils import tracing

# launches of each kernel, counted by its wrapper where it launches: the
# wgmma + TMA variant under the kernel's name, the mma.sync variant under
# the name + "_mma"
LAUNCH_COUNTS: Dict[str, int] = tracing.register({
    "conv3x3_fwd": 0, "conv3x3_dw": 0, "packed_conv": 0,
    "conv3x3_fwd_mma": 0, "conv3x3_dw_mma": 0, "packed_conv_mma": 0})

# Kernel against its plain version on the same bf16 inputs, max abs error
# over the plain version's largest |value|. fp32 outputs (the 3x3 forward
# and the kernel gradient): both sum exact bf16 products in fp32, in
# another order (the kernel by 16-deep tensor-core steps and, for the
# gradient, by pixel slices; the plain version through the matmul of its
# device), over up to 4 * 512 terms a forward output and N*H*W a gradient
# entry. bf16 output (the packed conv): one bf16 step of the largest value
# on top, since two fp32 sums a hair apart can round to neighbours.
KERNEL_TOL_F32 = 1e-4
KERNEL_TOL_BF16 = 2.0 ** -7 + 1e-4

# Pixels a stage of the mma.sync gradient kernel, and the blocks its split
# aims at (4 on each of the H100's 132 SMs).
_DW_PT = 64
_DW_TARGET_BLOCKS = 132 * 4
# Output pixels a tile of the wgmma kernels, and the CTAs the gradient's
# split aims at (one on each of the H100's 132 SMs: 178 KB of ring each).
_TILE = 128
_DT_TARGET_CTAS = 132

_C_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p)


def _lib():
    from crnerf_tpu_torch.ops import _build

    return _build.load("conv.cu", {"crnerf_conv_fwd": _C_ARGS,
                                   "crnerf_conv_dw": _C_ARGS})


# ------------------------------------------------------- plain versions
def conv_valid_plain(xpad: torch.Tensor, kernel: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """VALID conv, NHWC / HWIO, as one float32 matmul a tap of the upcast
    operands, summed in tap order, then cast to ``out_dtype``."""
    kh, kw, c, co = kernel.shape
    n, hp, wp, _ = xpad.shape
    h, w = hp - kh + 1, wp - kw + 1
    x, k = xpad.float(), kernel.float()
    out = None
    for i in range(kh):
        for j in range(kw):
            t = x[:, i:i + h, j:j + w, :].reshape(-1, c) @ k[i, j]
            out = t if out is None else out + t
    return out.reshape(n, h, w, co).to(out_dtype)


def conv3x3_dw_plain(xpad: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dK[i, j] = sum over pixels of the tap-shifted input (transposed)
    times dy, float32: nine explicit (C x pixels) @ (pixels x Co) sums."""
    n, h, w, co = dy.shape
    c = xpad.shape[-1]
    x, d = xpad.float(), dy.float().reshape(-1, co)
    return torch.stack([
        torch.stack([x[:, i:i + h, j:j + w, :].reshape(-1, c).T @ d
                     for j in range(3)])
        for i in range(3)])


# ------------------------------------------------- shapes to launches
def conv_variant(c: int, co: int) -> str:
    """The kernel variant for C input and Co output channels: "wgmma" (TMA
    loads and stores, wgmma) when both are multiples of 8, so that every
    row of the input, the kernel, dy and the output is 16-byte aligned, as
    TMA needs; else "mma" (mma.sync, element-by-element copies). A
    function of the shapes alone, taken before the launch."""
    return "wgmma" if c % 8 == 0 and co % 8 == 0 else "mma"


def conv_tile(h: int, w: int, taps: int):
    """-> (BW, BH): the wgmma kernels' output tile, BH rows of BW pixels,
    BW * BH = 128. BW is a multiple of 8 (a tap row's shift of the input
    box by BW rows stays on whole 128-byte swizzle atoms), and the input
    box, BH + taps - 1 rows of BW pixels, fits one 24 KB slot: BW <= 32
    for 3 taps, <= 64 for 2. Picks the fewest padded pixels
    (ceil(H / BH) BH x ceil(W / BW) BW), then the smallest box."""
    best = None
    for bw in (8, 16, 32, 64):
        bh = _TILE // bw
        if (bh + taps - 1) * bw > 192:
            continue
        padded = -(-h // bh) * bh * (-(-w // bw) * bw)
        key = (padded, (bh + taps - 1) * bw)
        if best is None or key < best[0]:
            best = (key, (bw, bh))
    return best[1]


def dw_slices(tiles: int, blocks: int) -> int:
    """-> the slices of the wgmma gradient kernel over ``tiles`` pixel
    tiles and ``blocks`` 64 x 64 (channel x out) blocks: about 132 CTAs in
    all, none empty. Slice s takes tiles [s * tiles // slices, (s + 1) *
    tiles // slices). A function of the shapes alone, so the fixed order of
    the sums, and hence the bits, depend on nothing else."""
    return max(1, min(tiles, _DT_TARGET_CTAS // blocks))


def _aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the wgmma kernels need 16-byte aligned "
                             "tensors (a view at an odd offset is not)")


# ------------------------------------------------------------- wrappers
def _check(name: str, t: torch.Tensor, dev, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16 on the card (the kernel "
                         f"has no fp32 variant), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _conv_fwd(xpad: torch.Tensor, kernel: torch.Tensor, taps: int,
              out_dtype: torch.dtype, counter: str) -> torch.Tensor:
    dev = xpad.device
    if dev.type == "cpu":
        return conv_valid_plain(xpad, kernel, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no conv kernel for device {dev}")
    if xpad.dim() != 4 or kernel.dim() != 4:
        raise ValueError(f"xpad must be NHWC and the kernel HWIO, got "
                         f"{tuple(xpad.shape)} and {tuple(kernel.shape)}")
    n, hp, wp, c = xpad.shape
    co = kernel.shape[-1]
    if n < 1 or hp < taps or wp < taps or c < 1 or co < 1:
        raise ValueError(f"xpad {tuple(xpad.shape)}: need N, C >= 1 and "
                         f"H, W >= {taps} with padding")
    _check("xpad", xpad, dev, (n, hp, wp, c))
    _check("kernel", kernel, dev, (taps, taps, c, co))
    h, w = hp - taps + 1, wp - taps + 1
    out = torch.empty((n, h, w, co), dtype=out_dtype, device=dev)
    wgmma = conv_variant(c, co) == "wgmma"
    if wgmma:
        _aligned(xpad, kernel, out)
    bw = conv_tile(h, w, taps)[0] if wgmma else 0
    ptrs = (ctypes.c_void_p * 3)(xpad.data_ptr(), kernel.data_ptr(),
                                 out.data_ptr())
    dims = (ctypes.c_int * 8)(n, hp, wp, c, co, taps, int(wgmma), bw)
    rc = _lib().crnerf_conv_fwd(ptrs, 3, dims, 8,
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crnerf_conv_fwd launch failed: error {rc}")
    LAUNCH_COUNTS[counter if wgmma else counter + "_mma"] += 1
    return out


def conv3x3_valid_fwd(xpad: torch.Tensor,
                      kernel: torch.Tensor) -> torch.Tensor:
    """xpad (N, H+2, W+2, C), kernel (3, 3, C, Co) -> (N, H, W, Co) f32."""
    return _conv_fwd(xpad, kernel, 3, torch.float32, "conv3x3_fwd")


def packed_conv(xp_pad: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """xp_pad (B, I+1, J+1, 4C) packed and pre-padded, k2 (2, 2, 4C, 4F)
    -> (B, I, J, 4F) in xp_pad's dtype."""
    return _conv_fwd(xp_pad, k2, 2, xp_pad.dtype, "packed_conv")


def dw_split(m: int, tiles: int):
    """-> (splits, pixels a split) of the mma.sync gradient kernel over m
    pixels and ``tiles`` output tiles: a function of the shapes alone, so
    the fixed order of the sums, and hence the bits, depend on nothing
    else."""
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // tiles), -(-m // _DW_PT)))
    m_per = -(-m // splits)
    m_per = -(-m_per // _DW_PT) * _DW_PT
    return -(-m // m_per), m_per


def conv3x3_dw(xpad: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """xpad (N, H+2, W+2, C), dy (N, H, W, Co) -> dK (3, 3, C, Co) f32."""
    dev = xpad.device
    if dev.type == "cpu":
        return conv3x3_dw_plain(xpad, dy)
    if dev.type != "cuda":
        raise ValueError(f"no conv kernel for device {dev}")
    if xpad.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"xpad and dy must be NHWC, got "
                         f"{tuple(xpad.shape)} and {tuple(dy.shape)}")
    n, hp, wp, c = xpad.shape
    co = dy.shape[-1]
    if n < 1 or hp < 3 or wp < 3 or c < 1 or co < 1:
        raise ValueError(f"xpad {tuple(xpad.shape)}: need N, C >= 1 and "
                         f"H, W >= 1 with padding")
    _check("xpad", xpad, dev, (n, hp, wp, c))
    _check("dy", dy, dev, (n, hp - 2, wp - 2, co))
    h, w = hp - 2, wp - 2
    blocks = -(-c // 64) * -(-co // 64)
    wgmma = conv_variant(c, co) == "wgmma"
    if wgmma:
        bw, bh = conv_tile(h, w, 3)
        splits = dw_slices(n * -(-h // bh) * -(-w // bw), blocks)
        per = 0
    else:
        bw = 0
        splits, per = dw_split(n * h * w, 9 * blocks)
    part = torch.empty((splits, 9 * c * co), dtype=torch.float32, device=dev)
    out = torch.empty((3, 3, c, co), dtype=torch.float32, device=dev)
    if wgmma:
        _aligned(xpad, dy, part)
    ptrs = (ctypes.c_void_p * 4)(xpad.data_ptr(), dy.data_ptr(),
                                 part.data_ptr(), out.data_ptr())
    dims = (ctypes.c_int * 9)(n, hp, wp, c, co, splits, per, int(wgmma), bw)
    rc = _lib().crnerf_conv_dw(ptrs, 4, dims, 9,
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crnerf_conv_dw launch failed: error {rc}")
    LAUNCH_COUNTS["conv3x3_dw" if wgmma else "conv3x3_dw_mma"] += 1
    return out


# ------------------------------------- space-to-depth packing (S4's inputs)
def _s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel order (p, q, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _d2s(y: torch.Tensor) -> torch.Tensor:
    """Inverse of _s2d for (p, q, f)-ordered output phases."""
    b, i, j, cf = y.shape
    f = cf // 4
    y = y.reshape(b, i, j, 2, 2, f)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * i, 2 * j, f)


def _s2d_assembly() -> torch.Tensor:
    """Static 0/1 tensor A[dy, dx, r, s, p', q', p, q] scattering a 3x3
    kernel into the S2D 2x2 kernel: tap (dy, dx) lands at S2D offset
    (r, s), input phase (p', q'), output phase (p, q) iff
    dy == 2r + p' - p and dx == 2s + q' - q."""
    a = torch.zeros((3, 3, 2, 2, 2, 2, 2, 2), dtype=torch.float32)
    for r in range(2):
        for s in range(2):
            for pp in range(2):
                for qq in range(2):
                    for p in range(2):
                        for q in range(2):
                            dy = 2 * r + pp - p
                            dx = 2 * s + qq - q
                            if 0 <= dy <= 2 and 0 <= dx <= 2:
                                a[dy, dx, r, s, pp, qq, p, q] = 1.0
    return a


def _pack_kernel3x3(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) -> the (2, 2, 4C, 4F) packed kernel of the equivalent
    2x2 conv on space-to-depth inputs (channel order (p, q, c)). Every
    packed entry is one kernel entry or zero, so the packing is exact."""
    c, f = kernel.shape[2], kernel.shape[3]
    a = _s2d_assembly().to(device=kernel.device, dtype=kernel.dtype)
    k2 = torch.einsum("yxcf,yxrsabpq->rsabcpqf", kernel, a)
    return k2.reshape(2, 2, 4 * c, 4 * f)


def packed_reflect_pad1(xp: torch.Tensor) -> torch.Tensor:
    """Reflect-pad-1 in packed space: (B, I, J, 4C) -> (B, I+1, J+1, 4C).

    The packed image of the reflect-padded original re-pairs rows as
    (-1,0), (1,2), ..., (H-1,H): new phase p=0 rows are the old phase-1
    rows [0, 0..I-1] (row -1 reflects to row 1 = old[0].p1) and new p=1
    rows are the old phase-0 rows [0..I-1, I-1] (row H reflects to H-2 =
    old[I-1].p0); columns the same on q. Slices and concatenations only."""
    b, i, j, c4 = xp.shape
    c = c4 // 4
    v = xp.reshape(b, i, j, 2, 2, c)
    p0 = torch.cat([v[:, :1, :, 1], v[:, :, :, 1]], 1)
    p1 = torch.cat([v[:, :, :, 0], v[:, i - 1:i, :, 0]], 1)
    v = torch.stack([p0, p1], dim=3)            # (b, i+1, j, 2, 2(q), c)
    q0 = torch.cat([v[:, :, :1, :, 1], v[:, :, :, :, 1]], 2)
    q1 = torch.cat([v[:, :, :, :, 0], v[:, :, j - 1:j, :, 0]], 2)
    v = torch.stack([q0, q1], dim=4)            # (b, i+1, j+1, 2, 2, c)
    return v.reshape(b, i + 1, j + 1, c4)
