"""Fused volume rendering of one pass: posenc + NeRF MLP + compositing in
ONE CUDA kernel (``csrc/fused_render_fwd.cu``), rays-in mode, forward.

Counterpart of ``crnerf_tpu/ops/fused_render.py`` ``fused_render_apply``
with ``rays_in=True``: inputs are per ray (origins, directions, z values,
sigma noise), xyz = o + d*z and the encode are made inside the kernel, and
only per-ray results leave it:

  ray block (N, round_up(C+1, 128)) f32 = [feature map (:C) | depth (C) | 0]
  weights   (N, S) f32

``render_fwd_plain`` is the plain PyTorch version of the same function with
the kernel's dtype policy (that of the JAX kernel's ``_mlp_fwd``, which
differs from the flax ``NerfMLP``): every matmul takes its operands at the
compute dtype and accumulates in fp32; every ReLU output, ``hf`` and ``dd``
are cast to the compute dtype; the sigma head runs at the compute dtype;
biases, softplus, sigmoid and compositing are fp32. ``exact_encode=False``
selects the anchored double-angle sin/cos recurrence (exact sin/cos every
``ANCHOR_SPAN`` octaves), as the bf16 configs do.

``fused_render_apply`` is the wrapper: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from crnerf_tpu_torch.core.compositing import composite
from crnerf_tpu_torch.core.encoding import posenc
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP, softplus

LANE = 128          # ray-block width granule (JAX layout)
ANCHOR_SPAN = 8     # exact sin/cos every 8 octaves in the recurrence
MAX_LAYERS = 16     # trunk depth the kernel takes
MAX_WIDTH = 256
MAX_C = 128

# launches of each kernel, counted by its wrapper where it launches
LAUNCH_COUNTS: Dict[str, int] = {"fused_render_fwd": 0}

# Kernel against render_fwd_plain on the same inputs, per compute dtype:
# max abs error of (weights, fmap, depth). fp32: the JAX package's own
# kernel-vs-twin tolerances (tests/test_ops.py); the two sides differ only
# in summation order and sin/cos ulps. bf16: both round to bf16 at the same
# points, but an fp32 sum near a rounding boundary can round to the other
# bf16 neighbour (2^-8 relative) and carry through later layers; 5x the
# fp32 bound, and 10x for depth (z up to 4.5).
KERNEL_TOL: Dict[torch.dtype, Tuple[float, float, float]] = {
    torch.float32: (1e-4, 1e-4, 2e-4),
    torch.bfloat16: (5e-4, 5e-4, 5e-3),
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class MlpParams(NamedTuple):
    """NerfMLP weights in the JAX kernel's (in, out) layout, biases (out,).
    trunk_w[i] for a skip layer is (Dxyz + W, W), x_emb rows first."""

    trunk_w: Tuple[torch.Tensor, ...]
    trunk_b: Tuple[torch.Tensor, ...]
    sigma_w: torch.Tensor     # (W, 1)
    sigma_b: torch.Tensor     # (1,)
    final_w: torch.Tensor     # (W, W)
    final_b: torch.Tensor
    dir_w: torch.Tensor       # (W + Ddir, W//2)
    dir_b: torch.Tensor
    feat_w: torch.Tensor      # (W//2, C)
    feat_b: torch.Tensor


def mlp_params_from_module(m: NerfMLP) -> MlpParams:
    t = lambda lin: lin.weight.detach().float().T  # noqa: E731
    b = lambda lin: lin.bias.detach().float()      # noqa: E731
    return MlpParams(
        trunk_w=tuple(t(m.trunk(i)) for i in range(m.depth)),
        trunk_b=tuple(b(m.trunk(i)) for i in range(m.depth)),
        sigma_w=t(m.sigma), sigma_b=b(m.sigma),
        final_w=t(m.xyz_encoding_final), final_b=b(m.xyz_encoding_final),
        dir_w=t(m.dir_encoding), dir_b=b(m.dir_encoding),
        feat_w=t(m.feature), feat_b=b(m.feature),
    )


# ------------------------------------------------------------ plain twin
def sincos_encode(x: torch.Tensor, n_freqs: int,
                  exact: bool = True) -> torch.Tensor:
    """x (M, 3) f32 -> (M, 3 + 6F) interleaved [x, sin 2^0 x, cos 2^0 x,
    ...]. exact: ``posenc`` (sin/cos of every 2^k x, exact power-of-two
    multipliers). Otherwise sin/cos at anchor octaves and the double-angle
    recurrence (sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a) between."""
    if exact:
        return posenc(x, n_freqs)
    ss, cs = [], []
    for a0 in range(0, n_freqs, ANCHOR_SPAN):
        va = x * float(2.0 ** a0)
        s_, c_ = torch.sin(va), torch.cos(va)
        ss.append(s_)
        cs.append(c_)
        for _ in range(min(ANCHOR_SPAN, n_freqs - a0) - 1):
            s_, c_ = 2.0 * s_ * c_, 1.0 - 2.0 * s_ * s_
            ss.append(s_)
            cs.append(c_)
    enc = torch.stack([torch.stack(ss, 1), torch.stack(cs, 1)], dim=-2)
    return torch.cat([x, enc.reshape(x.shape[0], -1)], -1)


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Operands rounded to dt, product and sum in fp32."""
    return a.to(dt).float() @ w.to(dt).float()


def render_fwd_plain(params: MlpParams, origins, dirs, z_vals, noise,
                     n_emb_xyz: int = 15, n_emb_dir: int = 4,
                     compute_dtype: torch.dtype = torch.float32,
                     exact_encode: bool = True,
                     skips: Tuple[int, ...] = (4,)):
    """Plain PyTorch version of the kernel: origins, dirs (N, 3), z_vals,
    noise (N, S) -> (ray block (N, c_pad) f32, weights (N, S) f32)."""
    n, s = z_vals.shape
    dt = compute_dtype
    xyz = origins[:, None, :] + dirs[:, None, :] * z_vals[..., None]
    enc = sincos_encode(xyz.reshape(-1, 3), n_emb_xyz, exact_encode)
    d_xyz = enc.shape[1]
    h = None
    for i, (w, b) in enumerate(zip(params.trunk_w, params.trunk_b)):
        if i == 0:
            acc = _mm(enc, w, dt)
        elif i in skips:
            acc = _mm(enc, w[:d_xyz], dt) + _mm(h, w[d_xyz:], dt)
        else:
            acc = _mm(h, w, dt)
        h = torch.relu(acc + b).to(dt)
    z_sig = _mm(h, params.sigma_w, dt) + params.sigma_b
    hf = (_mm(h, params.final_w, dt) + params.final_b).to(dt)
    width = params.final_w.shape[0]
    dir_enc = sincos_encode(dirs.float(), n_emb_dir, exact_encode)
    dir_term = _mm(dir_enc, params.dir_w[width:], dt)           # per ray
    zd = (_mm(hf, params.dir_w[:width], dt).reshape(n, s, -1)
          + dir_term[:, None, :] + params.dir_b)
    dd = torch.relu(zd).to(dt).reshape(n * s, -1)
    feat = torch.sigmoid(_mm(dd, params.feat_w, dt) + params.feat_b)
    feat = feat.reshape(n, s, -1)
    sigma = softplus(z_sig[:, 0]).reshape(n, s)
    weights, fmap, depth = composite(feat, sigma, z_vals, noise)
    c = feat.shape[-1]
    out = torch.zeros((n, _round_up(c + 1, LANE)), dtype=torch.float32,
                      device=z_vals.device)
    out[:, :c] = fmap
    out[:, c] = depth
    return out, weights


# ------------------------------------------------------- kernel weights
class KernelWeights(NamedTuple):
    """Weights laid out for the kernel (``prepare_kernel_weights``)."""

    params: MlpParams
    tensors: Tuple[Optional[torch.Tensor], ...]  # in the C pointer order
    dims: Dict[str, int]
    compute_dtype: torch.dtype
    n_emb_xyz: int
    n_emb_dir: int
    skips: Tuple[int, ...]


def pack_mma_b(b: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix, K % 16 == 0, N % 8 == 0 -> bf16 in the register order
    of mma.m16n8k16's B fragment: [k-step][n-tile][lane][4], so one warp
    reads each 16x8 tile as 256 contiguous bytes (one uint2 per lane).
    Lane l holds B[2t + {0,1}][g] and B[2t + 8 + {0,1}][g], g = l // 4,
    t = l % 4."""
    k, n = b.shape
    dev = b.device
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    j = torch.arange(4, device=dev)
    krow = t[:, None] * 2 + (j % 2)[None, :] + (j // 2)[None, :] * 8
    ks = (torch.arange(k // 16, device=dev)[:, None, None, None] * 16
          + krow[None, None])
    ns = (torch.arange(n // 8, device=dev)[None, :, None, None] * 8
          + g[None, None, :, None])
    return b[ks, ns].to(torch.bfloat16).contiguous()


def prepare_kernel_weights(params: MlpParams, n_emb_xyz: int = 15,
                           n_emb_dir: int = 4,
                           compute_dtype: torch.dtype = torch.float32,
                           skips: Tuple[int, ...] = (4,)) -> KernelWeights:
    """Pad every dimension to the kernel's granules (zero weights and
    biases: padded hidden units are exactly 0 after ReLU and meet zero
    rows downstream) and lay the matrices out for the kernel: bf16 in mma
    fragment order, or fp32 (K, N) row-major. Biases stay fp32."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} not supported")
    n_layers = len(params.trunk_w)
    width = params.final_w.shape[0]
    half = params.dir_w.shape[1]
    c = params.feat_w.shape[1]
    if not (1 <= n_layers <= MAX_LAYERS):
        raise ValueError(f"depth {n_layers} outside 1..{MAX_LAYERS}")
    if width % 16 or width > MAX_WIDTH:
        raise ValueError(f"width {width}: must be a multiple of 16, "
                         f"<= {MAX_WIDTH}")
    if c > MAX_C:
        raise ValueError(f"feature width {c} > {MAX_C}")
    if any(i < 1 for i in skips):
        raise ValueError(f"skips {skips}: layer 0 takes the encode alone")
    d_xyz = 3 + 6 * n_emb_xyz
    d_dir = 3 + 6 * n_emb_dir
    wp, hp, cp = _round_up(width, 32), _round_up(half, 32), _round_up(c, 32)
    ke = _round_up(d_xyz, 16)
    bf16 = compute_dtype == torch.bfloat16

    def mat(w, kp, np_):
        full = torch.zeros((kp, np_), dtype=torch.float32, device=w.device)
        full[:w.shape[0], :w.shape[1]] = w.float()
        return pack_mma_b(full) if bf16 else full.contiguous()

    def vec(b, np_):
        full = torch.zeros((np_,), dtype=torch.float32, device=b.device)
        full[:b.shape[0]] = b.float()
        return full

    wde = torch.zeros((d_dir, hp), dtype=torch.float32,
                      device=params.dir_w.device)
    wde[:, :half] = params.dir_w[width:].to(compute_dtype).float()
    tensors = [
        mat(params.sigma_w, wp, 32), vec(params.sigma_b, 32),
        mat(params.final_w, wp, wp), vec(params.final_b, wp),
        mat(params.dir_w[:width], wp, hp), vec(params.dir_b, hp),
        wde.contiguous(),
        mat(params.feat_w, hp, cp), vec(params.feat_b, cp),
    ]
    skip_mask = 0
    for i, (w, b) in enumerate(zip(params.trunk_w, params.trunk_b)):
        if i == 0:
            tensors += [mat(w, ke, wp), None]
        elif i in skips:
            skip_mask |= 1 << i
            tensors += [mat(w[:d_xyz], ke, wp), mat(w[d_xyz:], wp, wp)]
        else:
            tensors += [None, mat(w, wp, wp)]
        tensors.append(vec(b, wp))
    dims = dict(L=n_layers, skip_mask=skip_mask, WP=wp, HP=hp, CP=cp, C=c,
                KE=ke, F=n_emb_xyz, DK=d_dir, BF16=int(bf16))
    return KernelWeights(params, tuple(tensors), dims, compute_dtype,
                         n_emb_xyz, n_emb_dir, tuple(skips))


# ------------------------------------------------------------- wrapper
_DIMS_ORDER = ("N", "S", "L", "skip_mask", "WP", "HP", "CP", "C", "KE", "F",
               "DK", "exact", "ldo", "BF16")
_C_FN = "crnerf_render_fwd"


def _lib():
    from crnerf_tpu_torch.ops import _build

    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("fused_render_fwd.cu", {_C_FN: (vp, ci, vp, ci, vp)})


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_render_apply(
    kw: KernelWeights,
    origins: torch.Tensor,      # (N, 3) ray origins
    dirs: torch.Tensor,         # (N, 3) unit ray directions
    z_vals: torch.Tensor,       # (N, S)
    noise: torch.Tensor,        # (N, S) sigma noise (zeros at eval)
    exact_encode: bool = True,
):
    """-> (ray block (N, c_pad) f32 [fmap(:C) | depth(C) | 0], weights
    (N, S) f32) for weights laid out by ``prepare_kernel_weights`` (which
    fixes the compute dtype, frequencies and skips). CPU tensors take
    ``render_fwd_plain``; CUDA tensors launch the kernel."""
    if z_vals.device.type == "cpu":
        return render_fwd_plain(kw.params, origins, dirs, z_vals, noise,
                                kw.n_emb_xyz, kw.n_emb_dir, kw.compute_dtype,
                                exact_encode, kw.skips)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused render for device {z_vals.device}")
    dev = z_vals.device
    n, s = z_vals.shape
    if n == 0 or s == 0:
        raise ValueError(f"empty ray batch {tuple(z_vals.shape)}")
    _check("origins", origins, (n, 3), dev)
    _check("dirs", dirs, (n, 3), dev)
    _check("z_vals", z_vals, (n, s), dev)
    _check("noise", noise, (n, s), dev)
    for t in kw.tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"kernel weights on {t.device}, rays on {dev}")
    od = torch.cat([origins, dirs, origins.new_zeros((n, 2))], -1)
    dir_blk = sincos_encode(dirs, kw.n_emb_dir, exact_encode)
    dir_blk = dir_blk.to(kw.compute_dtype).float().contiguous()
    c = kw.dims["C"]
    ldo = _round_up(c + 1, LANE)
    out = torch.empty((n, ldo), dtype=torch.float32, device=dev)
    w_out = torch.empty((n, s), dtype=torch.float32, device=dev)
    ptr_list = [od, z_vals, noise, dir_blk, out, w_out, *kw.tensors]
    ptrs = (ctypes.c_void_p * len(ptr_list))(
        *[0 if t is None else t.data_ptr() for t in ptr_list]
    )
    dims = dict(kw.dims, N=n, S=s, exact=int(exact_encode), ldo=ldo)
    dim_arr = (ctypes.c_int * len(_DIMS_ORDER))(
        *[dims[k] for k in _DIMS_ORDER]
    )
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, _C_FN)(ptrs, len(ptr_list), dim_arr, len(_DIMS_ORDER),
                             stream)
    if rc != 0:
        raise RuntimeError(f"fused_render_fwd launch failed: cudaError {rc}")
    LAUNCH_COUNTS["fused_render_fwd"] += 1
    return out, w_out
