"""Fused volume rendering of one pass: posenc + NeRF MLP + compositing in
ONE CUDA kernel (``csrc/fused_render_fwd.cuh``), and its two backwards: from
an activation stash (``csrc/fused_render_bwd.cuh``) or by recomputing the
forward slab by slab (``csrc/fused_render_bwd_recompute.cu``). Each ``.cu``
of ``csrc/`` is one library's C entry points over those headers.

Counterpart of ``crnerf_tpu/ops/fused_render.py`` ``fused_render_apply``
and ``make_fused_render_train``. Rays-in (``rays_in=True``): inputs are per
ray (origins, directions, z values, sigma noise), xyz = o + d*z and the
encode are made inside the kernel. Xyz-in (``rays_in=False``, ``xyz=``
here): one coordinate per sample point (N, S, 3) is read in place of
o + d*z, for callers that jitter the points; depth still uses z. Only
per-ray results leave the kernel:

  ray block (N, round_up(C+1, 128)) f32 = [feature map (:C) | depth (C) | 0]
  weights   (N, S) f32

Training with ``stash=True`` (rays-in or xyz-in here; the JAX package has
it for rays-in only): the forward also writes the stash, one row per
sample point at the compute dtype, [h_0 .. h_{L-1} | hf | dd | encode] in
the kernel's padded widths (``grad_layout``): bit for bit the values its
products consumed. The backward reads it and returns a float32 gradient for
every weight and bias, summed over all points, and nothing for rays, z or
noise. It is two kernels: the per-ray chain that writes every layer's dz,
and the split-K weight gradient dW = A^T dZ; both sum in a fixed order, so
the gradients of two runs on the same inputs are bit-identical.

Training with ``stash=False``: the forward keeps nothing but its inputs.
The backward walks the rays in slabs of a fixed size; for each slab it runs
the stash forward again into a scratch stash, then the chain and the weight
gradient on it, and adds the slab's gradients onto those before, in slab
order. The scratch holds one slab whatever N is (``slab_rays_for``).

``render_fwd_plain`` / ``render_bwd_plain`` are the plain PyTorch versions
with the kernels' dtype policy (that of the JAX kernels' ``_mlp_fwd`` and
stash backward, which differs from the flax ``NerfMLP``): every matmul
takes its operands (activations, weights, dz) at the compute dtype and
accumulates in fp32; every ReLU output, ``hf`` and ``dd`` are cast to the
compute dtype; the sigma head runs at the compute dtype; biases, softplus,
sigmoid, compositing and the bias sums are fp32. ``exact_encode=False``
selects the anchored double-angle sin/cos recurrence (exact sin/cos every
``ANCHOR_SPAN`` octaves), as the bf16 configs do.

``render_bwd_recompute_plain`` is the plain version of the slab backward.

``fused_render_apply`` (inference) and ``fused_render_train`` (a
``torch.autograd.Function``) are the wrappers: a CPU tensor goes to the
plain versions; a CUDA tensor launches the kernels or raises.

The forward, the backward's chain and the recompute backward each have
two kernels for the same function. The wgmma kernels
(``csrc/fused_render_fwd_wgmma.cuh``, ``csrc/fused_render_bwd_wgmma.cuh``:
TMA-streamed weights, warpgroup products over 128-row tiles) take bf16 at
the served MLPs' widths, the one shape they are built for: the forward
with and without the stash, the chain, and the recompute's slabs, which
run those two. The mma.sync kernels (``csrc/fused_render_fwd.cuh``,
``csrc/fused_render_bwd.cuh``) take everything else: fp32, other widths,
deeper trunks and longer rays than the wgmma chain takes. The weight
gradient has three kernels, chosen by ``wgrad_variant``: on wgmma
(``csrc/wgrad_wgmma.cuh``: 128-row tiles of a job's whole dz width in
clusters of two, both operands TMA boxes, a job's dz boxes loaded once for
its two tiles) at bf16 and the served widths, on mma.sync at other
bf16 widths, and an fp32 one; the stash backward and the slabs of the
recompute and of the fused MLP's backward all take it. The no-stash
training forward takes the recompute's variant (``recompute_variant``),
so that a step's forward and its backward's recompute are one kernel's
bits. ``render_variant``, ``chain_variant`` and ``recompute_variant``
choose by shape before the launch; each variant counts its launches apart
(``LAUNCH_COUNTS``: the mma.sync kernels' under ``*_mma``, the fp32
weight gradient's under ``*_fp32``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from crnerf_tpu_torch.core.compositing import DELTA_INF, composite
from crnerf_tpu_torch.core.encoding import posenc
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP, softplus
from crnerf_tpu_torch.utils import tracing

LANE = 128          # ray-block width granule (JAX layout)
ANCHOR_SPAN = 8     # exact sin/cos every 8 octaves in the recurrence
MAX_LAYERS = 16     # trunk depth the kernel takes
MAX_WIDTH = 256
MAX_C = 128

# launches of each kernel, counted by its wrapper where it launches
LAUNCH_COUNTS: Dict[str, int] = tracing.register({
    "fused_render_fwd": 0,          # forward, rays-in, no stash (wgmma)
    "fused_render_fwd_xyz": 0,      # forward, xyz-in, no stash (wgmma)
    "fused_render_fwd_mma": 0,      # the same on the mma.sync kernel
    "fused_render_fwd_xyz_mma": 0,
    "fused_render_fwd_stash": 0,    # forward with the stash (wgmma)
    "fused_render_fwd_stash_mma": 0,
    "fused_render_bwd": 0,          # backward, the per-ray dz chain (wgmma)
    "fused_render_bwd_mma": 0,
    "fused_render_bwd_wgrad": 0,    # backward, the split-K weight gradient
                                    # (wgmma), also inside K3's and K4-bwd's
                                    # slabs: one a slab
    "fused_render_bwd_wgrad_mma": 0,     # the same, bf16 on mma.sync
    "fused_render_bwd_wgrad_fp32": 0,    # the same, the fp32 kernel
    "fused_render_bwd_recompute": 0,      # recompute backward, rays-in
    "fused_render_bwd_recompute_xyz": 0,  # recompute backward, xyz-in
    "fused_render_bwd_recompute_mma": 0,  # the same on the mma.sync triple
    "fused_render_bwd_recompute_xyz_mma": 0,
})

# Scratch of the recompute backward: the slab's stash and dz buffer together
# stay under this many bytes (``slab_rays_for``). 2 GiB holds ~1,600 rays
# of 128 samples at 8x256 bf16 (10,112 bytes a point): twelve waves of the
# wgmma kernels, six grids of the mma.sync chain. The mma.sync triple's
# time hardly depends on it (``tools/slab_ab`` on an H100, 16,384 x 128
# bf16: 72.4 ms with slabs of one grid and 366 MiB, 69.7 ms at 1.3 GiB,
# 69.3 ms here, 70.5 ms with one slab of 20 GB), so the budget is what a
# step can always spare beside its other ~2 GiB.
RECOMPUTE_SCRATCH_BYTES = 2 << 30

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

# The backward kernels against render_bwd_plain on the same stash and
# cotangents, per compute dtype: max abs error of each gradient tensor over
# that tensor's largest absolute value. fp32: the order of fp32 sums over
# ~1e5 points (measured 5.4e-6 at 1024 rays x 128 samples, 8x256). bf16:
# both sides round every dz to bf16; where an fp32 sum lands on the other
# side of a rounding boundary that element moves by 2^-8 and carries into
# the layers below, and a weight-gradient split sums its points in fp32
# (measured on an H100, 8x256: 3.6e-4 at 1024 rays x 128 samples; at the
# train step's 16,384 rays, against slices summed in fp64, 2.2e-4 at 64
# samples and 8.3e-4 at 128, of which the weight-gradient kernel alone is
# 2.4e-4 with ~190k points per split; small shapes average over fewer
# points).
GRAD_TOL: Dict[torch.dtype, float] = {
    torch.float32: 1e-4,
    torch.bfloat16: 1e-2,
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


def mlp_params_from_module(m: NerfMLP, detach: bool = True) -> MlpParams:
    """The module's weights as (in, out) views. ``detach=False`` keeps them
    on the autograd graph, so a gradient for an ``MlpParams`` tensor flows
    back onto the module's parameter (training)."""
    keep = (lambda x: x.detach()) if detach else (lambda x: x)
    t = lambda lin: keep(lin.weight).float().T  # noqa: E731
    b = lambda lin: keep(lin.bias).float()      # noqa: E731
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


def render_points_plain(params: MlpParams, xyz, dirs,
                        n_emb_xyz: int = 15, n_emb_dir: int = 4,
                        compute_dtype: torch.dtype = torch.float32,
                        exact_encode: bool = True,
                        skips: Tuple[int, ...] = (4,)):
    """The MLP half of the plain version: sample points xyz (N, S, 3), dirs
    (N, 3) -> (features (N, S, C) in [0, 1], sigma (N, S) >= 0, both f32,
    and what the stash keeps: trunk ReLU outputs, hf, dd, encode). What is
    left of the pass is ``core.compositing.composite``."""
    n, s = xyz.shape[:2]
    dt = compute_dtype
    enc = sincos_encode(xyz.reshape(-1, 3), n_emb_xyz, exact_encode)
    d_xyz = enc.shape[1]
    h = None
    acts = []
    for i, (w, b) in enumerate(zip(params.trunk_w, params.trunk_b)):
        if i == 0:
            acc = _mm(enc, w, dt)
        elif i in skips:
            acc = _mm(enc, w[:d_xyz], dt) + _mm(h, w[d_xyz:], dt)
        else:
            acc = _mm(h, w, dt)
        h = torch.relu(acc + b).to(dt)
        acts.append(h)
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
    return feat, sigma, (acts, hf, dd, enc)


def render_fwd_plain(params: MlpParams, origins, dirs, z_vals, noise,
                     n_emb_xyz: int = 15, n_emb_dir: int = 4,
                     compute_dtype: torch.dtype = torch.float32,
                     exact_encode: bool = True,
                     skips: Tuple[int, ...] = (4,), stash: bool = False,
                     xyz: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: origins, dirs (N, 3), z_vals,
    noise (N, S) -> (ray block (N, c_pad) f32, weights (N, S) f32), and
    with ``stash`` also the activation stash (N*S, SC) at the compute
    dtype in the kernel's layout (``grad_layout``). ``xyz`` (N, S, 3)
    f32: the sample points, in place of origins + dirs * z (``origins``
    is then not read)."""
    n, s = z_vals.shape
    dt = compute_dtype
    if xyz is None:
        xyz = origins[:, None, :] + dirs[:, None, :] * z_vals[..., None]
    feat, sigma, (acts, hf, dd, enc) = render_points_plain(
        params, xyz, dirs, n_emb_xyz, n_emb_dir, dt, exact_encode, skips)
    width, d_xyz = params.final_w.shape[0], enc.shape[1]
    weights, fmap, depth = composite(feat, sigma, z_vals, noise)
    c = feat.shape[-1]
    out = torch.zeros((n, _round_up(c + 1, LANE)), dtype=torch.float32,
                      device=z_vals.device)
    out[:, :c] = fmap
    out[:, c] = depth
    if not stash:
        return out, weights
    lay = grad_layout(_dims_of(params, n_emb_xyz, n_emb_dir, dt, skips))
    wp = _round_up(width, 32)
    st = torch.zeros((n * s, lay.sc), dtype=dt, device=z_vals.device)
    for i, a in enumerate(acts):
        st[:, i * wp:i * wp + width] = a
    st[:, lay.o_hf:lay.o_hf + width] = hf
    st[:, lay.o_dd:lay.o_dd + dd.shape[1]] = dd
    st[:, lay.o_enc:lay.o_enc + d_xyz] = enc.to(dt)
    return out, weights, st


# ------------------------------------------------------- kernel weights
class KernelWeights(NamedTuple):
    """Weights laid out for the kernels (``prepare_kernel_weights``)."""

    params: MlpParams
    tensors: Tuple[Optional[torch.Tensor], ...]  # in the C pointer order
    dims: Dict[str, int]
    compute_dtype: torch.dtype
    n_emb_xyz: int
    n_emb_dir: int
    skips: Tuple[int, ...]
    padded: Dict[object, torch.Tensor]  # fp32 (K, N) / (N,) in padded widths
    # layouts made from these at their first use (``wgmma_weights``)
    derived: Dict[str, torch.Tensor]


def pack_mma_b(b: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix, K % 16 == 0, N % 8 == 0 -> bf16 in the register order
    of mma.m16n8k16's B fragment: [k-step][n-tile][lane][4], so one warp
    reads each 16x8 tile as 256 contiguous bytes (one uint2 per lane).
    Lane l holds B[2t + {0,1}][g] and B[2t + 8 + {0,1}][g], g = l // 4,
    t = l % 4."""
    k, n = b.shape
    # k = 16 kt + 8 h + 2 t + j0, n = 8 nt + g -> [kt][nt][4 g + t][2 h + j0]
    v = b.reshape(k // 16, 2, 4, 2, n // 8, 8).permute(0, 4, 5, 2, 1, 3)
    return v.reshape(k // 16, n // 8, 32, 4).to(torch.bfloat16).contiguous()


WGMMA_KE = 128     # encode columns of the wgmma kernel (KE padded)
WGMMA_SIGMA_N = 8  # the wgmma kernels' sigma head: a 64 x 8 product
WGMMA_CHAIN_MAX_L = 8    # csrc/fused_render_bwd_wgmma.cuh CW_MAX_L
WGMMA_CHAIN_MAX_S = 256  # CW_MAX_S


@functools.lru_cache(maxsize=None)
def _swizzle_index(k: int, n: int) -> torch.Tensor:
    """(K // 64, N, 64) int64 on the CPU: for each element of
    ``pack_wgmma_b``'s output, the position in the row-major (K, N)
    matrix of the element it holds."""
    kc = torch.arange(k // 64).view(-1, 1, 1, 1)
    col = torch.arange(n).view(1, -1, 1, 1)
    chunk = torch.arange(8).view(1, 1, -1, 1) ^ (col % 8)
    row = 64 * kc + 8 * chunk + torch.arange(8).view(1, 1, 1, -1)
    return (row * n + col).reshape(k // 64, n, 64)


def pack_wgmma_b(b: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix, K % 64 == 0, N % 8 == 0 -> (K // 64, N, 64) of b's
    dtype (bf16 where the kernels read it; positions for ``_stream_index``):
    per 64-deep K-slice the shared-memory image wgmma reads as a K-major B
    operand in the 128-byte swizzle, row n holding B[64 kc : 64 kc + 64,
    n] with its 16-byte chunk q at q ^ (n % 8). One slice is one
    contiguous bulk copy. XOR is its own inverse: the same gather unpacks
    it."""
    k, n = b.shape
    return b.reshape(-1)[_swizzle_index(k, n).to(b.device)]


def _source_keys(dims: Dict[str, int]):
    """The padded matrices the wgmma streams are cut from, in the order
    ``_flat_weights`` lays them end to end, with their (K, N) shapes (the
    dir-encode rows last: only the fused MLP's stream reads them)."""
    wp, hp, cp, ke = dims["WP"], dims["HP"], dims["CP"], dims["KE"]
    keys = []
    for i in range(dims["L"]):
        if i == 0 or (dims["skip_mask"] >> i) & 1:
            keys.append((("wenc", i), (ke, wp)))
        if i > 0:
            keys.append((("wh", i), (wp, wp)))
    keys += [("ws", (wp, 32)), ("wf", (wp, wp)), ("wdh", (wp, hp)),
             ("wc", (hp, cp)), ("wde", (dims["DK"], hp))]
    return keys


WGMMA_DIR_K = 64   # the fused MLP's dir-encode slice (csrc MW_DIR_K)


@functools.lru_cache(maxsize=None)
def _stream_index(dims_key, form: str, device_str: str) -> torch.Tensor:
    """The positions in ``_flat_weights`` of a wgmma stream's elements, on
    the device, once per dimensions. ``form`` "fwd": every product's B in
    the order the fused render's forward takes them: per trunk layer the
    encode rows (zero rows up to ``WGMMA_KE``) then the hidden rows, the
    sigma head's first ``WGMMA_SIGMA_N`` columns, the final layer, the dir
    layer's hidden rows, the feature head. "mlp": the fused MLP's forward
    (``ops.fused_mlp``): the trunk as "fwd", the final layer, the dir
    layer's hidden rows, its dir-encode rows (zero rows up to
    ``WGMMA_DIR_K``: one more slice of the same product), the feature
    head. "chain": the sigma columns and the feature head as the forward
    takes them, then W^T of the feature head, the dir layer's hidden rows,
    the final layer and the trunk layers L-1 .. 1 (hidden rows), in the
    order the chain takes them. Each matrix as ``pack_wgmma_b`` lays it
    out."""
    dims = dict(dims_key)
    base, off = {}, 0
    for key, (k, n) in _source_keys(dims):
        base[key] = (off, k, n)
        off += k * n
    zero = off                      # the zero ``_flat_weights`` ends with

    def mat(key, k=None, n=None, transpose=False):
        """Positions of B = the padded matrix (or its transpose), its K
        padded with zero rows up to k, its first n columns."""
        b0, rows, cols = base[key]
        pos = b0 + torch.arange(rows * cols).reshape(rows, cols)
        if transpose:
            pos = pos.T
        k = k or pos.shape[0]
        n = n or pos.shape[1]
        full = torch.full((k, n), zero, dtype=torch.int64)
        full[:pos.shape[0]] = pos[:, :n]
        return pack_wgmma_b(full).reshape(-1)

    n_layers = dims["L"]
    if form == "chain":
        parts = [mat("ws", n=WGMMA_SIGMA_N), mat("wc"),
                 mat("wc", transpose=True), mat("wdh", transpose=True),
                 mat("wf", transpose=True)]
        parts += [mat(("wh", i), transpose=True)
                  for i in range(n_layers - 1, 0, -1)]
    else:
        parts = []
        for i in range(n_layers):
            if ("wenc", i) in base:
                parts.append(mat(("wenc", i), k=WGMMA_KE))
            if ("wh", i) in base:
                parts.append(mat(("wh", i)))
        if form == "mlp":
            parts += [mat("wf"), mat("wdh"), mat("wde", k=WGMMA_DIR_K),
                      mat("wc")]
        else:
            parts += [mat("ws", n=WGMMA_SIGMA_N), mat("wf"), mat("wdh"),
                      mat("wc")]
    return torch.cat(parts).to(device_str)


@functools.lru_cache(maxsize=None)
def _zero(device_str: str) -> torch.Tensor:
    return torch.zeros(1, device=device_str)


def _flat_weights(kw: "KernelWeights") -> torch.Tensor:
    """Every padded matrix of the layout end to end at bf16, then a zero:
    what the wgmma streams gather from. Made once a layout."""
    flat = kw.derived.get("flat")
    if flat is None:
        dev = kw.padded["ws"].device
        mats = [kw.padded[key].reshape(-1) for key, _ in
                _source_keys(kw.dims)]
        flat = torch.cat(mats + [_zero(str(dev))]).to(torch.bfloat16)
        kw.derived["flat"] = flat
    return flat


_STREAM_NAMES = {"fwd": "wgmma", "chain": "wgmma_chain", "mlp": "wgmma_mlp"}


def _stream(kw: "KernelWeights", form: str) -> torch.Tensor:
    """The ``_stream_index`` form's stream, gathered at its first use in
    one indexing launch and kept in ``kw.derived``."""
    name = _STREAM_NAMES[form]
    stream = kw.derived.get(name)
    if stream is None:
        flat = _flat_weights(kw)
        idx = _stream_index(tuple(sorted(kw.dims.items())), form,
                            str(flat.device))
        stream = kw.derived[name] = flat[idx]
    return stream


def wgmma_weights(kw: "KernelWeights") -> torch.Tensor:
    """The wgmma forward's weight stream (``_stream_index``), gathered at
    its first use in one indexing launch and kept with the layout. A
    training step makes a new layout, so its stash forward gathers it once
    a pass."""
    return _stream(kw, "fwd")


def wgmma_chain_weights(kw: "KernelWeights") -> torch.Tensor:
    """The wgmma chain's weight stream (``_stream_index`` with
    form "chain"), gathered as ``wgmma_weights`` is."""
    return _stream(kw, "chain")


def _served_widths(dims: Dict[str, int]) -> bool:
    return bool(dims["BF16"] and dims["WP"] == 256 and dims["HP"] == 128
                and dims["CP"] == 64)


def render_variant(dims: Dict[str, int]) -> str:
    """The forward kernel for a layout's dimensions, with or without the
    stash: "wgmma" at bf16 and the one width it is built for, the served
    MLPs' (WP 256, HP 128, CP 64, the encode within ``WGMMA_KE``
    columns), else "mma". A function of the shapes alone, taken before
    the launch (the no-stash training forward names
    ``recompute_variant``'s itself)."""
    fits = _served_widths(dims) and 3 + 6 * dims["F"] <= WGMMA_KE
    return "wgmma" if fits else "mma"


def chain_variant(dims: Dict[str, int], s: int) -> str:
    """The backward's chain kernel for a layout's dimensions and s samples
    a ray: "wgmma" at bf16 and the served MLPs' widths with at most
    ``WGMMA_CHAIN_MAX_L`` trunk layers (its bias sums' shared memory) and
    ``WGMMA_CHAIN_MAX_S`` samples (its compositing scan), else "mma"."""
    fits = (_served_widths(dims) and dims["L"] <= WGMMA_CHAIN_MAX_L
            and s <= WGMMA_CHAIN_MAX_S)
    return "wgmma" if fits else "mma"


def wgrad_variant(dims: Dict[str, int]) -> str:
    """The weight gradient's kernel for a layout's dimensions, by one rule
    for every caller (the stash backward, the recompute's and the fused
    MLP's slabs): "wgmma" at bf16 and the served MLPs' widths, "mma" at
    other bf16 widths, "fp32" at fp32."""
    if not dims["BF16"]:
        return "fp32"
    return "wgmma" if _served_widths(dims) else "mma"


def recompute_variant(dims: Dict[str, int], s: int) -> str:
    """The recompute backward's kernels for a layout's dimensions and s
    samples a ray, and so the no-stash training forward's, whose bits the
    recompute must give again: "wgmma" (the wgmma stash forward and chain
    a slab) where both wgmma kernels take the shape, else "mma" (the
    mma.sync triple, forward included)."""
    both = render_variant(dims) == chain_variant(dims, s) == "wgmma"
    return "wgmma" if both else "mma"


def _dims_of(params: MlpParams, n_emb_xyz: int, n_emb_dir: int,
             compute_dtype: torch.dtype,
             skips: Tuple[int, ...]) -> Dict[str, int]:
    """The kernels' dimensions: every width padded to its granule."""
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
    skip_mask = 0
    for i in skips:
        if i < n_layers:
            skip_mask |= 1 << i
    return dict(L=n_layers, skip_mask=skip_mask, WP=_round_up(width, 32),
                HP=_round_up(half, 32), CP=_round_up(c, 32), C=c,
                KE=_round_up(3 + 6 * n_emb_xyz, 16), F=n_emb_xyz,
                DK=3 + 6 * n_emb_dir,
                BF16=int(compute_dtype == torch.bfloat16))


def prepare_kernel_weights(params: MlpParams, n_emb_xyz: int = 15,
                           n_emb_dir: int = 4,
                           compute_dtype: torch.dtype = torch.float32,
                           skips: Tuple[int, ...] = (4,)) -> KernelWeights:
    """Pad every dimension to the kernel's granules (zero weights and
    biases: padded hidden units are exactly 0 after ReLU and meet zero
    rows downstream) and lay the matrices out for the kernel: bf16 in mma
    fragment order, or fp32 (K, N) row-major. Biases stay fp32. The wgmma
    kernel's stream is packed from ``padded`` at its first launch
    (``wgmma_weights``). The layout is a snapshot of ``params``: a caller
    whose weights move (training) prepares again after every update."""
    dims = _dims_of(params, n_emb_xyz, n_emb_dir, compute_dtype, skips)
    width = params.final_w.shape[0]
    half = params.dir_w.shape[1]
    d_xyz = 3 + 6 * n_emb_xyz
    d_dir = dims["DK"]
    wp, hp, cp, ke = dims["WP"], dims["HP"], dims["CP"], dims["KE"]
    bf16 = bool(dims["BF16"])

    def mat(w, kp, np_):
        full = torch.zeros((kp, np_), dtype=torch.float32, device=w.device)
        full[:w.shape[0], :w.shape[1]] = w.detach().float()
        return full

    def vec(b, np_):
        full = torch.zeros((np_,), dtype=torch.float32, device=b.device)
        full[:b.shape[0]] = b.detach().float()
        return full

    pad: Dict[object, torch.Tensor] = {
        "ws": mat(params.sigma_w, wp, 32), "bs": vec(params.sigma_b, 32),
        "wf": mat(params.final_w, wp, wp), "bf": vec(params.final_b, wp),
        "wdh": mat(params.dir_w[:width], wp, hp),
        "bd": vec(params.dir_b, hp),
        # the dir-encode rows stay fp32 in the kernel: rounded here
        "wde": mat(params.dir_w[width:].detach().to(compute_dtype), d_dir,
                   hp),
        "wc": mat(params.feat_w, hp, cp), "bc": vec(params.feat_b, cp),
    }
    for i, (w, b) in enumerate(zip(params.trunk_w, params.trunk_b)):
        if i == 0:
            pad["wenc", 0] = mat(w, ke, wp)
        elif (dims["skip_mask"] >> i) & 1:
            pad["wenc", i] = mat(w[:d_xyz], ke, wp)
            pad["wh", i] = mat(w[d_xyz:], wp, wp)
        else:
            pad["wh", i] = mat(w, wp, wp)
        pad["b", i] = vec(b, wp)
    lay = pack_mma_b if bf16 else (lambda m: m)
    tensors = [lay(pad["ws"]), pad["bs"], lay(pad["wf"]), pad["bf"],
               lay(pad["wdh"]), pad["bd"], pad["wde"], lay(pad["wc"]),
               pad["bc"]]
    for i in range(dims["L"]):
        for key in (("wenc", i), ("wh", i)):
            tensors.append(lay(pad[key]) if key in pad else None)
        tensors.append(pad["b", i])
    return KernelWeights(params, tuple(tensors), dims, compute_dtype,
                         n_emb_xyz, n_emb_dir, tuple(skips), pad, {})


# ----------------------------------------------------------- grad layout
class GradLayout(NamedTuple):
    """Columns of the stash and of the dz buffer, and the flat layouts of
    the padded gradients. Stash row: h_i at i*WP, then hf, dd, encode. dz
    row (and the bias gradients, which are its column sums): dz_i at i*WP,
    then dhf, dz_sigma (32 wide, column 0), ddd, dz_feat; the bias vector
    carries the (DK, HP) dir-encode weight gradient after them. ``jobs``:
    one weight gradient each, (key, stash column, K, dz column, N, offset
    of its (K, N) row-major block in the flat weight gradients)."""

    sc: int
    dc: int
    bt: int
    wt: int
    o_hf: int
    o_dd: int
    o_enc: int
    d_hf: int
    d_sig: int
    d_ddd: int
    d_feat: int
    jobs: Tuple[Tuple[object, int, int, int, int, int], ...]


def grad_layout(dims: Dict[str, int]) -> GradLayout:
    return _grad_layout(dims["L"], dims["skip_mask"], dims["WP"], dims["HP"],
                        dims["CP"], dims["KE"], dims["DK"])


@functools.lru_cache(maxsize=None)
def _grad_layout(n_layers, skip_mask, wp, hp, cp, ke, dk) -> GradLayout:
    o_hf, o_dd = n_layers * wp, (n_layers + 1) * wp
    o_enc = o_dd + hp
    d_hf, d_sig = n_layers * wp, (n_layers + 1) * wp
    d_ddd = d_sig + 32
    d_feat = d_ddd + hp
    dc = d_feat + cp
    jobs, off = [], 0

    def job(key, a_col, k, b_col, n):
        nonlocal off
        jobs.append((key, a_col, k, b_col, n, off))
        off += k * n

    for i in range(n_layers):
        if i == 0 or (skip_mask >> i) & 1:
            job(("wenc", i), o_enc, ke, i * wp, wp)
        if i > 0:
            job(("wh", i), (i - 1) * wp, wp, i * wp, wp)
    job("wf", (n_layers - 1) * wp, wp, d_hf, wp)
    job("ws", (n_layers - 1) * wp, wp, d_sig, 32)
    job("wdh", o_hf, wp, d_ddd, hp)
    job("wc", o_dd, hp, d_feat, cp)
    return GradLayout(sc=o_enc + ke, dc=dc, bt=dc + dk * hp, wt=off,
                      o_hf=o_hf, o_dd=o_dd, o_enc=o_enc, d_hf=d_hf,
                      d_sig=d_sig, d_ddd=d_ddd, d_feat=d_feat,
                      jobs=tuple(jobs))


def unpack_grads(kw: KernelWeights, gw: torch.Tensor,
                 gb: torch.Tensor) -> MlpParams:
    """Flat padded gradients (``GradLayout``) -> gradients in the layout of
    ``MlpParams``: the inverse of ``prepare_kernel_weights``' padding and
    split of the skip and dir layers. Padded units are dropped (their
    gradients are exactly zero)."""
    lay = grad_layout(kw.dims)
    p = kw.params
    width, half = p.final_w.shape[0], p.dir_w.shape[1]
    c, d_xyz = p.feat_w.shape[1], 3 + 6 * kw.n_emb_xyz
    wp, hp, dk = kw.dims["WP"], kw.dims["HP"], kw.dims["DK"]
    blocks = {key: gw[off:off + k * n].reshape(k, n)
              for key, _, k, _, n, off in lay.jobs}
    trunk_w, trunk_b = [], []
    for i in range(kw.dims["L"]):
        parts = []
        if ("wenc", i) in blocks:
            parts.append(blocks["wenc", i][:d_xyz, :width])
        if ("wh", i) in blocks:
            parts.append(blocks["wh", i][:width, :width])
        trunk_w.append(torch.cat(parts, 0))
        trunk_b.append(gb[i * wp:i * wp + width])
    g_wde = gb[lay.dc:lay.dc + dk * hp].reshape(dk, hp)[:, :half]
    return MlpParams(
        trunk_w=tuple(trunk_w), trunk_b=tuple(trunk_b),
        sigma_w=blocks["ws"][:width, :1],
        sigma_b=gb[lay.d_sig:lay.d_sig + 1],
        final_w=blocks["wf"][:width, :width],
        final_b=gb[lay.d_hf:lay.d_hf + width],
        dir_w=torch.cat([blocks["wdh"][:width, :half], g_wde], 0),
        dir_b=gb[lay.d_ddd:lay.d_ddd + half],
        feat_w=blocks["wc"][:half, :c],
        feat_b=gb[lay.d_feat:lay.d_feat + c],
    )


# ------------------------------------------------- plain backward (twin)
def bwd_chain_plain(kw: KernelWeights, z_vals, noise, dir_blk, stash, g_ray,
                    g_w):
    """Plain version of the backward's first kernel: the compositing
    backward and the dh chain from the stash -> (dz buffer (N*S, DC) at
    the compute dtype, bias / dir-encode gradients (BT,) f32). An explicit
    backward that rounds where the JAX kernel rounds: every product
    operand, dz included, at the compute dtype; sums in fp32."""
    dims, pad, dt = kw.dims, kw.padded, kw.compute_dtype
    lay = grad_layout(dims)
    n_layers, wp, hp, cp, c = (dims["L"], dims["WP"], dims["HP"], dims["CP"],
                               dims["C"])
    n, s = z_vals.shape
    r = lambda x: x.to(dt).float()                 # noqa: E731
    mm = lambda a, w: r(a) @ r(w)                  # noqa: E731
    mm_bt = lambda dz, w: r(dz) @ r(w).T           # noqa: E731
    st = stash.float()
    h = [st[:, i * wp:(i + 1) * wp] for i in range(n_layers)]
    dd = st[:, lay.o_dd:lay.o_dd + hp]
    # the cheap heads again, and the compositing forward
    z_sig = mm(h[-1], pad["ws"])[:, :1] + pad["bs"][:1]
    feat = torch.sigmoid(mm(dd, pad["wc"]) + pad["bc"])
    sigma = softplus(z_sig).reshape(n, s)
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                        torch.full_like(z_vals[:, :1], DELTA_INF)], -1)
    act = torch.relu(sigma + noise)
    gone = torch.exp(-deltas * act)
    alphas = 1.0 - gone
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]),
                                     1.0 - alphas[:, :-1]], -1), -1)
    weights = alphas * trans
    # compositing backward
    dfmap = torch.zeros((n, cp), dtype=torch.float32, device=z_vals.device)
    dfmap[:, :c] = g_ray[:, :c]
    ddepth = g_ray[:, c:c + 1]
    g_ft = torch.einsum("nc,nsc->ns", dfmap, feat.reshape(n, s, cp))
    dw = g_w + ddepth * z_vals + g_ft
    wdw = weights * dw
    suffix = torch.flip(torch.cumsum(torch.flip(wdw, (-1,)), -1),
                        (-1,)) - wdw
    dalpha = trans * dw - suffix / torch.clamp_min(1.0 - alphas, 1e-30)
    dact = dalpha * deltas * gone
    dsigma = torch.where(sigma + noise > 0, dact, torch.zeros_like(dact))
    dfeat = (weights[..., None] * dfmap[:, None, :]).reshape(n * s, cp)
    # MLP backward
    dz = {}
    dz["feat"] = dfeat * feat * (1.0 - feat)
    ddd = torch.where(dd > 0, mm_bt(dz["feat"], pad["wc"]),
                      torch.zeros_like(dd))
    dz["ddd"] = ddd
    ddd_ray = ddd.reshape(n, s, hp).sum(1)
    g_wde = r(dir_blk).T @ r(ddd_ray)
    dz["hf"] = mm_bt(ddd, pad["wdh"])
    dz_sig = dsigma.reshape(-1, 1) * torch.sigmoid(z_sig)
    dh = mm_bt(dz["hf"], pad["wf"]) + r(dz_sig) * r(pad["ws"][:, 0])[None]
    for i in range(n_layers - 1, -1, -1):
        dz[i] = torch.where(h[i] > 0, dh, torch.zeros_like(dh))
        if i > 0:
            dh = mm_bt(dz[i], pad["wh", i])
    sig_blk = torch.zeros((n * s, 32), dtype=torch.float32,
                          device=z_vals.device)
    sig_blk[:, :1] = dz_sig
    cols = [dz[i] for i in range(n_layers)] + [dz["hf"], sig_blk, dz["ddd"],
                                                dz["feat"]]
    full = torch.cat(cols, 1)
    gb = torch.cat([full.sum(0), g_wde.reshape(-1)])
    return full.to(dt), gb


def bwd_wgrad_plain(kw: KernelWeights, stash, dzbuf,
                    lay: Optional[GradLayout] = None) -> torch.Tensor:
    """Plain version of the backward's second kernel: every weight
    gradient dW = A^T dZ over all points, A a column block of the stash,
    dZ of the dz buffer (both already at the compute dtype), summed in
    fp32 -> flat padded weight gradients (WT,) f32. ``lay``: the jobs of
    another layout than the fused render's (``ops.fused_mlp``)."""
    lay = lay or grad_layout(kw.dims)
    st, dz = stash.float(), dzbuf.float()
    gw = torch.empty((lay.wt,), dtype=torch.float32, device=stash.device)
    for _, a_col, k, b_col, n, off in lay.jobs:
        gw[off:off + k * n] = (st[:, a_col:a_col + k].T
                               @ dz[:, b_col:b_col + n]).reshape(-1)
    return gw


def render_bwd_plain(params: MlpParams, z_vals, noise, dirs, stash, g_ray,
                     g_w, n_emb_xyz: int = 15, n_emb_dir: int = 4,
                     compute_dtype: torch.dtype = torch.float32,
                     exact_encode: bool = True,
                     skips: Tuple[int, ...] = (4,)) -> MlpParams:
    """Plain PyTorch version of the backward kernels: the cotangents of
    the ray block (N, c_pad) and of the weights (N, S), with the forward's
    stash -> a float32 gradient for every tensor of ``params``."""
    kw = prepare_kernel_weights(params, n_emb_xyz, n_emb_dir, compute_dtype,
                                skips)
    dzbuf, gb = bwd_chain_plain(kw, z_vals, noise,
                                dir_block(kw, dirs, exact_encode), stash,
                                g_ray, g_w)
    return unpack_grads(kw, bwd_wgrad_plain(kw, stash, dzbuf), gb)


# ------------------------------------------------------------- wrappers
_FWD_DIMS = ("N", "S", "L", "skip_mask", "WP", "HP", "CP", "C", "KE", "F",
             "DK", "exact", "ldo", "BF16", "SC")
_CHAIN_DIMS = ("N", "S", "L", "WP", "HP", "CP", "C", "DK", "ldo", "SC", "DC",
               "slices", "BF16", "grid")
_WGRAD_DIMS = ("M", "SC", "DC", "WT", "n_tiles", "splits", "m_per", "WK")
_RECOMPUTE_DIMS = _FWD_DIMS + ("DC", "slices", "grid", "WT", "n_tiles",
                               "splits", "m_per", "R", "WK")
_C_FN = "crnerf_render_fwd"
_C_FN_WGMMA = "crnerf_render_fwd_wgmma"
_C_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p)
# each weight-gradient kernel's output tile (rows, columns: the wgmma
# kernel's a job's whole dz width), points a step, and its number in the C
# entry (csrc/wgrad_wgmma.cuh WgradKernel)
_WGRAD_TILES = {"wgmma": (128, MAX_WIDTH, 64), "mma": (128, 128, 64),
                "fp32": (64, 64, 32)}
_WGRAD_KERNEL = {"fp32": 0, "mma": 1, "wgmma": 2}
# the wgmma weight gradient's grid: about this many waves of (tile, split)
# items, one CTA an SM, each split at least WGRAD_MIN_STEPS steps of points.
# Two waves keep the partials (splits x WT fp32) at 26 MiB at 8x256, under
# the mma.sync kernel's 31 MiB, for under 2% (tools/wgrad_ab on an H100 at
# 700 W: 9.996 ms against eight waves' 9.929 at 16,384 x 128, 0.945
# against 0.927 on a K3 slab, eight waves' partials 105 MiB).
WGRAD_WAVES = 2
WGRAD_MIN_STEPS = 16


def _lib():
    from crnerf_tpu_torch.ops import _build

    return _build.load("fused_render_fwd.cu", {_C_FN: _C_ARGS,
                                               _C_FN_WGMMA: _C_ARGS})


def _lib_bwd():
    from crnerf_tpu_torch.ops import _build

    return _build.load("fused_render_bwd.cu",
                       {"crnerf_render_bwd_chain": _C_ARGS,
                        "crnerf_render_bwd_chain_wgmma": _C_ARGS,
                        "crnerf_render_bwd_wgrad": _C_ARGS})


def _lib_recompute():
    from crnerf_tpu_torch.ops import _build

    return _build.load("fused_render_bwd_recompute.cu",
                       {"crnerf_render_bwd_recompute": _C_ARGS,
                        "crnerf_render_bwd_recompute_wgmma": _C_ARGS})


def _call(lib, fn_name: str, tensors, dims: Dict[str, int], order, dev):
    """One C entry point: pointers of ``tensors`` (None -> 0), the ints of
    ``dims`` in ``order``, on the current stream of ``dev``."""
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors]
    )
    dim_arr = (ctypes.c_int * len(order))(*[dims[k] for k in order])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, fn_name)(ptrs, len(tensors), dim_arr, len(order),
                               stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")


def _check(name: str, t: torch.Tensor, shape, device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {str(dtype)[6:]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dir_block(kw: KernelWeights, dirs: torch.Tensor,
               exact_encode: bool) -> torch.Tensor:
    """(N, DK) direction encode at the compute dtype, held as f32."""
    enc = sincos_encode(dirs.float(), kw.n_emb_dir, exact_encode)
    return enc.to(kw.compute_dtype).float().contiguous()


def _check_rays(kw: KernelWeights, origins, dirs, z_vals, noise, xyz):
    """The forward's inputs on one CUDA device -> the (N, 8) [o | d | 0]
    rows the rays-in kernel reads (None with ``xyz``)."""
    dev = z_vals.device
    n, s = z_vals.shape
    if n == 0 or s == 0:
        raise ValueError(f"empty ray batch {tuple(z_vals.shape)}")
    _check("dirs", dirs, (n, 3), dev)
    _check("z_vals", z_vals, (n, s), dev)
    _check("noise", noise, (n, s), dev)
    for t in kw.tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"kernel weights on {t.device}, rays on {dev}")
    if xyz is not None:
        _check("xyz", xyz, (n, s, 3), dev)
        return None
    _check("origins", origins, (n, 3), dev)
    return torch.cat([origins, dirs, origins.new_zeros((n, 2))], -1)


def render_fwd(kw: KernelWeights, origins, dirs, z_vals, noise,
                exact_encode: bool, stash: bool,
                xyz: Optional[torch.Tensor] = None,
                variant: Optional[str] = None):
    """-> (ray block, weights, stash or None): the plain version for CPU
    tensors, the kernel for CUDA tensors. ``xyz`` (N, S, 3): the xyz-in
    form (``origins`` may then be None). ``variant``: the kernel, "wgmma"
    or "mma"; None takes ``render_variant``'s by shape. The no-stash
    training forward (``recompute_variant``'s) and the checks that compare
    bits with the mma.sync kernel name it; "wgmma" raises where that
    kernel does not take the shape."""
    chosen = render_variant(kw.dims)
    variant = chosen if variant is None else variant
    if variant not in ("wgmma", "mma"):
        raise ValueError(f"variant {variant!r}: 'wgmma' or 'mma'")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma forward does not take dims {kw.dims} "
                         f"with stash={stash}")
    if z_vals.device.type == "cpu":
        res = render_fwd_plain(kw.params, origins, dirs, z_vals, noise,
                               kw.n_emb_xyz, kw.n_emb_dir, kw.compute_dtype,
                               exact_encode, kw.skips, stash=stash, xyz=xyz)
        return res if stash else (*res, None)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused render for device {z_vals.device}")
    dev = z_vals.device
    n, s = z_vals.shape
    od = _check_rays(kw, origins, dirs, z_vals, noise, xyz)
    dir_blk = dir_block(kw, dirs, exact_encode)
    ldo = _round_up(kw.dims["C"] + 1, LANE)
    out = torch.empty((n, ldo), dtype=torch.float32, device=dev)
    w_out = torch.empty((n, s), dtype=torch.float32, device=dev)
    sc = grad_layout(kw.dims).sc
    st = (torch.empty((n * s, sc), dtype=kw.compute_dtype, device=dev)
          if stash else None)
    dims = dict(kw.dims, N=n, S=s, exact=int(exact_encode), ldo=ldo, SC=sc)
    tensors = [od, z_vals, noise, dir_blk, out, w_out, st, xyz, *kw.tensors]
    if variant == "wgmma":
        _call(_lib(), _C_FN_WGMMA, tensors + [wgmma_weights(kw)], dims,
              _FWD_DIMS, dev)
    else:
        _call(_lib(), _C_FN, tensors, dims, _FWD_DIMS, dev)
    key = ("fused_render_fwd_stash" if stash
           else "fused_render_fwd" if xyz is None else "fused_render_fwd_xyz")
    LAUNCH_COUNTS[key if variant == "wgmma" else key + "_mma"] += 1
    return out, w_out, st


def fused_render_apply(
    kw: KernelWeights,
    origins: Optional[torch.Tensor],  # (N, 3) ray origins (None with xyz)
    dirs: torch.Tensor,         # (N, 3) unit ray directions
    z_vals: torch.Tensor,       # (N, S)
    noise: torch.Tensor,        # (N, S) sigma noise (zeros at eval)
    exact_encode: bool = True,
    xyz: Optional[torch.Tensor] = None,   # (N, S, 3): the xyz-in form
):
    """-> (ray block (N, c_pad) f32 [fmap(:C) | depth(C) | 0], weights
    (N, S) f32) for weights laid out by ``prepare_kernel_weights`` (which
    fixes the compute dtype, frequencies and skips). CPU tensors take
    ``render_fwd_plain``; CUDA tensors launch the kernel. No gradient:
    training goes through ``fused_render_train``. The kernel is
    ``render_variant``'s for the layout: the wgmma one at the bf16 widths
    it takes."""
    out, w_out, _ = render_fwd(kw, origins, dirs, z_vals, noise,
                                exact_encode, stash=False, xyz=xyz)
    return out, w_out


@functools.lru_cache(maxsize=None)
def _tile_table(lay: GradLayout, tile: int, device_str: str,
                tile_n: int = 0) -> torch.Tensor:
    """(n_tiles, 6) int32 on the device: a_col, k_valid, b_col, n_valid,
    out_off, ld_out of every ``tile`` x ``tile_n`` (default ``tile``)
    output tile of ``jobs``, job by job, the tiles of a job row block by
    row block."""
    tile_n = tile_n or tile
    rows = []
    for _, a_col, k, b_col, n, off in lay.jobs:
        for tm in range(0, k, tile):
            for tn in range(0, n, tile_n):
                rows.append([a_col + tm, min(tile, k - tm), b_col + tn,
                             min(tile_n, n - tn), off + tm * n + tn, n])
    return torch.tensor(rows, dtype=torch.int32, device=device_str)


@functools.lru_cache(maxsize=None)
def _pair_table(lay: GradLayout, device_str: str) -> torch.Tensor:
    """The wgmma weight gradient's table for clusters of two CTAs (rows 2i
    and 2i + 1 a cluster; csrc/wgrad_wgmma.cuh): a job's two 128-row tiles
    of its whole dz width side by side, then the jobs of one 128-row tile
    two by two, the last beside a row of zeros (k_valid 0: nothing to
    do)."""
    table = _tile_table(lay, 128, "cpu", MAX_WIDTH).tolist()
    rows, single = [], []
    i = 0
    for _, _, k, _, _, _ in lay.jobs:
        tiles = table[i:i + -(-k // 128)]
        i += len(tiles)
        if len(tiles) > 2:
            raise ValueError(f"a job of {k} rows: the pairs take <= 256")
        if len(tiles) == 2:
            rows += tiles
        else:
            single += tiles
    if len(single) % 2:
        single.append([0] * 6)
    return torch.tensor(rows + single, dtype=torch.int32, device=device_str)


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _chain_grid(kw: KernelWeights, n: int, dev) -> Tuple[int, int]:
    """-> (CTAs of the mma.sync chain kernel's persistent grid over n
    rays: the bf16 kernel fits two on an SM, fp32 one; slices of the rays
    in the dir-encode gradient)."""
    return min(n, _sm_count(dev) * (2 if kw.dims["BF16"] else 1)), min(n, 32)


def _rays_per_item(s: int) -> int:
    """Rays a work item of the wgmma kernels: two when s <= 64 (a
    warpgroup a ray), else one (tiles of 128 samples)."""
    return 2 if s <= 64 else 1


def _chain_grid_wgmma(n: int, s: int, dev) -> Tuple[int, int]:
    """-> (CTAs of the wgmma chain's grid, one an SM over its items: rays,
    or pairs of rays when s <= 64; slices as ``_chain_grid``'s)."""
    items = -(-n // _rays_per_item(s))
    return min(items, _sm_count(dev)), min(n, 32)


def _chain_scratch(kw: KernelWeights, n: int, grid: int, slices: int, dev):
    """The chain kernel's small scratch for n rays: per-CTA bias partials,
    each ray's summed ddd, per-slice dir-encode partials."""
    dc, hp, dk = grad_layout(kw.dims).dc, kw.dims["HP"], kw.dims["DK"]
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((grid, dc), **f32), torch.empty((n, hp), **f32),
            torch.empty((slices, dk * hp), **f32))


def _chain_weights(kw: KernelWeights):
    """The chain kernel's own weight operands: the sigma column at the
    compute dtype, then W^T of the feature head, the dir layer's hidden
    rows, the final layer and trunk layers 1..L-1, laid out as the forward
    lays out W."""
    pad = kw.padded
    lay_t = pack_mma_b if kw.dims["BF16"] else (lambda m: m.contiguous())
    wsv = pad["ws"][:, 0].to(kw.compute_dtype).float().contiguous()
    transposed = [lay_t(pad["wc"].T), lay_t(pad["wdh"].T), lay_t(pad["wf"].T)]
    transposed += [lay_t(pad["wh", i].T) for i in range(1, kw.dims["L"])]
    return [wsv, *transposed]


def bwd_chain(kw: KernelWeights, z_vals, noise, dir_blk, stash, g_ray, g_w,
              variant: Optional[str] = None):
    """The backward's first kernel (``bwd_chain_plain`` on CPU tensors).
    ``variant``: "wgmma" or "mma"; None takes ``chain_variant``'s by
    shape; "wgmma" raises where that kernel does not take the shape."""
    n, s = z_vals.shape
    chosen = chain_variant(kw.dims, s)
    variant = chosen if variant is None else variant
    if variant not in ("wgmma", "mma"):
        raise ValueError(f"variant {variant!r}: 'wgmma' or 'mma'")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma chain does not take dims {kw.dims} "
                         f"at S={s}")
    if z_vals.device.type == "cpu":
        return bwd_chain_plain(kw, z_vals, noise, dir_blk, stash, g_ray, g_w)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused render for device {z_vals.device}")
    dev, dt, pad = z_vals.device, kw.compute_dtype, kw.padded
    lay = grad_layout(kw.dims)
    ldo = _round_up(kw.dims["C"] + 1, LANE)
    _check("z_vals", z_vals, (n, s), dev)
    _check("noise", noise, (n, s), dev)
    _check("dir block", dir_blk, (n, kw.dims["DK"]), dev)
    _check("g_ray", g_ray, (n, ldo), dev)
    _check("g_w", g_w, (n, s), dev)
    _check("stash", stash, (n * s, lay.sc), dev, dt)
    if variant == "wgmma":
        grid, slices = _chain_grid_wgmma(n, s, dev)
    else:
        grid, slices = _chain_grid(kw, n, dev)
    dzbuf = torch.empty((n * s, lay.dc), dtype=dt, device=dev)
    gb = torch.empty((lay.bt,), dtype=torch.float32, device=dev)
    dims = dict(kw.dims, N=n, S=s, ldo=ldo, SC=lay.sc, DC=lay.dc,
                slices=slices, grid=grid)
    head = [z_vals, noise, dir_blk, g_ray, g_w, stash, dzbuf,
            *_chain_scratch(kw, n, grid, slices, dev), gb]
    if variant == "wgmma":
        wsv = pad["ws"][:, 0].to(dt).float().contiguous()
        _call(_lib_bwd(), "crnerf_render_bwd_chain_wgmma",
              head + [pad["bs"], pad["bc"], wsv, wgmma_chain_weights(kw)],
              dims, _CHAIN_DIMS, dev)
        LAUNCH_COUNTS["fused_render_bwd"] += 1
    else:
        _call(_lib_bwd(), "crnerf_render_bwd_chain",
              head + [kw.tensors[0], pad["bs"], kw.tensors[7], pad["bc"],
                      *_chain_weights(kw)], dims, _CHAIN_DIMS, dev)
        LAUNCH_COUNTS["fused_render_bwd_mma"] += 1
    return dzbuf, gb


def wgrad_splits(variant: str, n_tiles: int, m: int, sms: int) -> int:
    """Splits of m points for the weight gradient's grid of n_tiles tiles
    on a card of ``sms`` SMs. wgmma: about ``WGRAD_WAVES`` waves of (tile,
    split) items, one CTA an SM, each split at least ``WGRAD_MIN_STEPS``
    steps of points. The others: a few waves, at least four steps a
    split."""
    pts = _WGRAD_TILES[variant][2]
    if variant == "wgmma":
        return max(1, min(-(-m // (WGRAD_MIN_STEPS * pts)),
                          WGRAD_WAVES * sms // n_tiles))
    return max(1, min(-(-m // (4 * pts)), -(-4 * sms // n_tiles)))


def _wgrad_plan(kw: KernelWeights, m: int, dev,
                lay: Optional[GradLayout] = None,
                variant: Optional[str] = None):
    """-> (tile table, splits of the m points, points per split (a
    multiple of the kernel's step), the kernel's number in the C entry)
    for ``variant`` (default ``wgrad_variant``'s)."""
    variant = variant or wgrad_variant(kw.dims)
    tile, tile_n, pts = _WGRAD_TILES[variant]
    lay = lay or grad_layout(kw.dims)
    tiles = (_pair_table(lay, str(dev)) if variant == "wgmma"
             else _tile_table(lay, tile, str(dev), tile_n))
    splits = wgrad_splits(variant, tiles.shape[0], m, _sm_count(dev))
    return (tiles, splits, _round_up(-(-m // splits), pts),
            _WGRAD_KERNEL[variant])


def _wgrad_key(variant: str) -> str:
    """The launch counter of a weight-gradient kernel."""
    return ("fused_render_bwd_wgrad" if variant == "wgmma"
            else f"fused_render_bwd_wgrad_{variant}")


def bwd_wgrad(kw: KernelWeights, stash, dzbuf,
              variant: Optional[str] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward's second kernel (``bwd_wgrad_plain`` on CPU tensors).
    ``variant``: "wgmma", "mma" or "fp32"; None takes ``wgrad_variant``'s
    by shape. At bf16 "mma" may be named at every width (the checks that
    compare with the mma.sync kernel), "wgmma" only where
    ``wgrad_variant`` takes it; at fp32 only "fp32". ``out`` (WT,) f32:
    the sums are added onto it, in place (as the recompute's slabs add
    theirs), and it is returned."""
    chosen = wgrad_variant(kw.dims)
    variant = chosen if variant is None else variant
    allowed = {chosen, "mma"} if kw.dims["BF16"] else {"fp32"}
    if variant not in allowed:
        raise ValueError(f"the weight gradient takes {sorted(allowed)} at "
                         f"dims {kw.dims}, not {variant!r}")
    if stash.device.type == "cpu":
        gw = bwd_wgrad_plain(kw, stash, dzbuf)
        return gw if out is None else out.add_(gw)
    if stash.device.type != "cuda":
        raise ValueError(f"no fused render for device {stash.device}")
    dev, dt = stash.device, kw.compute_dtype
    lay = grad_layout(kw.dims)
    m = stash.shape[0]
    _check("stash", stash, (m, lay.sc), dev, dt)
    _check("dz buffer", dzbuf, (m, lay.dc), dev, dt)
    if out is not None:
        _check("out", out, (lay.wt,), dev)
    tiles, splits, m_per, wk = _wgrad_plan(kw, m, dev, variant=variant)
    part = torch.empty((splits, lay.wt), dtype=torch.float32, device=dev)
    gw = (torch.empty((lay.wt,), dtype=torch.float32, device=dev)
          if out is None else out)
    dims = dict(M=m, SC=lay.sc, DC=lay.dc, WT=lay.wt,
                n_tiles=tiles.shape[0], splits=splits, m_per=m_per, WK=wk,
                acc=int(out is not None))
    _call(_lib_bwd(), "crnerf_render_bwd_wgrad",
          [stash, dzbuf, tiles, part, gw], dims, _WGRAD_DIMS + ("acc",),
          dev)
    LAUNCH_COUNTS[_wgrad_key(variant)] += 1
    return gw


def fused_render_bwd(kw: KernelWeights, z_vals, noise, dirs, stash, g_ray,
                     g_w, exact_encode: bool = True,
                     variant: Optional[str] = None) -> MlpParams:
    """Gradients of every tensor of ``kw.params`` from the cotangents of
    the ray block and of the weights and the forward's stash: the two
    backward kernels on CUDA tensors, their plain versions on CPU
    tensors. ``variant``: the chain's, as ``bwd_chain`` takes it."""
    dir_blk = dir_block(kw, dirs, exact_encode)
    dzbuf, gb = bwd_chain(kw, z_vals, noise, dir_blk, stash,
                          g_ray.float().contiguous(),
                          g_w.float().contiguous(), variant)
    gw = bwd_wgrad(kw, stash, dzbuf)
    return unpack_grads(kw, gw, gb)


def slab_rays_for(kw: KernelWeights, n: int, s: int, device=None,
                  budget: int = RECOMPUTE_SCRATCH_BYTES,
                  variant: Optional[str] = None) -> int:
    """Rays per slab of the recompute backward over n rays of s samples:
    as many as keep the slab's stash and dz buffer under ``budget`` bytes,
    whatever n is; on a card, no nearly empty last wave: with the wgmma
    kernels (``variant``, default ``recompute_variant``'s) a whole number
    of their waves of items (an SM's worth of rays, or of pairs of rays
    when s <= 64) and an even number of rays (two waves where a wave is
    odd), an even number below that; with mma.sync a whole number of the
    chain kernel's grids when it is more than one."""
    lay = grad_layout(kw.dims)
    per_ray = s * (lay.sc + lay.dc) * (2 if kw.dims["BF16"] else 4)
    r = max(1, budget // per_ray)
    if r >= n:
        return n
    if device is not None and torch.device(device).type == "cuda":
        if (variant or recompute_variant(kw.dims, s)) == "wgmma":
            wave = _sm_count(device) * _rays_per_item(s)
            step = wave if wave % 2 == 0 else 2 * wave
            if r >= step:
                r -= r % step
            elif r > 1:
                r -= r % 2
        else:
            grid, _ = _chain_grid(kw, r, device)
            if r > grid:
                r -= r % grid
    return r


def bwd_recompute_plain(kw: KernelWeights, origins, dirs, z_vals, noise,
                        g_ray, g_w, exact_encode: bool = True, xyz=None,
                        slab_rays: Optional[int] = None):
    """Plain version of the recompute backward: slab by slab the stash
    forward again, the chain and the weight gradient (their plain
    versions), each slab's flat padded gradients added onto the slabs
    before in slab order -> (gw (WT,), gb (BT,), the last slab's (stash, dz
    buffer))."""
    n, s = z_vals.shape
    r = min(n, slab_rays or slab_rays_for(kw, n, s))
    dir_blk = dir_block(kw, dirs, exact_encode)
    gw = gb = scratch = None
    for r0 in range(0, n, r):
        sl = slice(r0, r0 + r)
        _, _, st = render_fwd_plain(
            kw.params, None if origins is None else origins[sl], dirs[sl],
            z_vals[sl], noise[sl], kw.n_emb_xyz, kw.n_emb_dir,
            kw.compute_dtype, exact_encode, kw.skips, stash=True,
            xyz=None if xyz is None else xyz[sl])
        dzbuf, gb_s = bwd_chain_plain(kw, z_vals[sl], noise[sl], dir_blk[sl],
                                      st, g_ray[sl], g_w[sl])
        gw_s = bwd_wgrad_plain(kw, st, dzbuf)
        gw = gw_s if gw is None else gw + gw_s
        gb = gb_s if gb is None else gb + gb_s
        scratch = (st, dzbuf)
    return gw, gb, scratch


def render_bwd_recompute_plain(params: MlpParams, origins, dirs, z_vals,
                               noise, g_ray, g_w, n_emb_xyz: int = 15,
                               n_emb_dir: int = 4,
                               compute_dtype: torch.dtype = torch.float32,
                               exact_encode: bool = True,
                               skips: Tuple[int, ...] = (4,), xyz=None,
                               slab_rays: Optional[int] = None) -> MlpParams:
    """Plain PyTorch version of the recompute backward kernel: the
    forward's inputs (``xyz`` (N, S, 3) in place of origins for the xyz-in
    form) and the cotangents of the ray block (N, c_pad) and of the weights
    (N, S) -> a float32 gradient for every tensor of ``params``."""
    kw = prepare_kernel_weights(params, n_emb_xyz, n_emb_dir, compute_dtype,
                                skips)
    gw, gb, _ = bwd_recompute_plain(kw, origins, dirs, z_vals, noise, g_ray,
                                    g_w, exact_encode, xyz, slab_rays)
    return unpack_grads(kw, gw, gb)


def bwd_recompute(kw: KernelWeights, origins, dirs, z_vals, noise, g_ray,
                  g_w, exact_encode: bool = True, xyz=None,
                  slab_rays: Optional[int] = None,
                  variant: Optional[str] = None):
    """The recompute backward kernel (``bwd_recompute_plain`` on CPU
    tensors) -> (gw (WT,), gb (BT,), the scratch (stash, dz buffer) as the
    last slab left it). One call walks every slab; the scratch holds
    ``slab_rays`` rays (default ``slab_rays_for``) whatever N is.
    ``variant``: "wgmma" or "mma"; None takes ``recompute_variant``'s by
    shape; "wgmma" raises where its kernels do not take the shape."""
    n, s = z_vals.shape
    chosen = recompute_variant(kw.dims, s)
    variant = chosen if variant is None else variant
    if variant not in ("wgmma", "mma"):
        raise ValueError(f"variant {variant!r}: 'wgmma' or 'mma'")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma recompute does not take dims {kw.dims} "
                         f"at S={s}")
    if z_vals.device.type == "cpu":
        return bwd_recompute_plain(kw, origins, dirs, z_vals, noise, g_ray,
                                   g_w, exact_encode, xyz, slab_rays)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused render for device {z_vals.device}")
    dev, dt = z_vals.device, kw.compute_dtype
    lay = grad_layout(kw.dims)
    ldo = _round_up(kw.dims["C"] + 1, LANE)
    od = _check_rays(kw, origins, dirs, z_vals, noise, xyz)
    _check("g_ray", g_ray, (n, ldo), dev)
    _check("g_w", g_w, (n, s), dev)
    r = min(n, slab_rays or slab_rays_for(kw, n, s, dev, variant=variant))
    if r < 1:
        raise ValueError(f"slab of {r} rays")
    if variant == "wgmma":
        grid, slices = _chain_grid_wgmma(r, s, dev)
    else:
        grid, slices = _chain_grid(kw, r, dev)
    tiles, splits, m_per, wk = _wgrad_plan(kw, r * s, dev)
    stash = torch.empty((r * s, lay.sc), dtype=dt, device=dev)
    dzbuf = torch.empty((r * s, lay.dc), dtype=dt, device=dev)
    part = torch.empty((splits, lay.wt), dtype=torch.float32, device=dev)
    gw = torch.empty((lay.wt,), dtype=torch.float32, device=dev)
    gb = torch.empty((lay.bt,), dtype=torch.float32, device=dev)
    dims = dict(kw.dims, N=n, S=s, exact=int(exact_encode), ldo=ldo,
                SC=lay.sc, DC=lay.dc, slices=slices, grid=grid, WT=lay.wt,
                n_tiles=tiles.shape[0], splits=splits, m_per=m_per, R=r,
                WK=wk)
    head = [od, xyz, z_vals, noise, dir_block(kw, dirs, exact_encode), g_ray,
            g_w, stash, dzbuf, *_chain_scratch(kw, r, grid, slices, dev), gb,
            tiles, part, gw]
    if variant == "wgmma":
        wsv = kw.padded["ws"][:, 0].to(dt).float().contiguous()
        _call(_lib_recompute(), "crnerf_render_bwd_recompute_wgmma",
              head + [wsv, wgmma_chain_weights(kw), wgmma_weights(kw),
                      *kw.tensors], dims, _RECOMPUTE_DIMS, dev)
    else:
        _call(_lib_recompute(), "crnerf_render_bwd_recompute",
              head + [*_chain_weights(kw), *kw.tensors], dims,
              _RECOMPUTE_DIMS, dev)
    key = ("fused_render_bwd_recompute" if xyz is None
           else "fused_render_bwd_recompute_xyz")
    LAUNCH_COUNTS[key if variant == "wgmma" else key + "_mma"] += 1
    # the weight gradient, one launch a slab inside the entry
    LAUNCH_COUNTS[_wgrad_key(wgrad_variant(kw.dims))] += -(-n // r)
    return gw, gb, (stash, dzbuf)


def fused_render_bwd_recompute(kw: KernelWeights, origins, dirs, z_vals,
                               noise, g_ray, g_w, exact_encode: bool = True,
                               xyz=None, slab_rays: Optional[int] = None,
                               variant: Optional[str] = None) -> MlpParams:
    """Gradients of every tensor of ``kw.params`` from the forward's inputs
    and the cotangents of the ray block and of the weights, with no stash
    from the forward: the recompute backward kernel on CUDA tensors, its
    plain version on CPU tensors. ``variant`` as ``bwd_recompute`` takes
    it."""
    gw, gb, _ = bwd_recompute(kw, origins, dirs, z_vals, noise,
                              g_ray.float().contiguous(),
                              g_w.float().contiguous(), exact_encode, xyz,
                              slab_rays, variant)
    return unpack_grads(kw, gw, gb)


def flatten_params(p: MlpParams) -> Tuple[torch.Tensor, ...]:
    return (*p.trunk_w, *p.trunk_b, *p[2:])


def unflatten_params(flat) -> MlpParams:
    n_layers = (len(flat) - 8) // 2
    return MlpParams(tuple(flat[:n_layers]),
                     tuple(flat[n_layers:2 * n_layers]),
                     *flat[2 * n_layers:])


class FusedRenderTrain(torch.autograd.Function):
    """Counterpart of ``make_fused_render_train``. Gradients come back for
    the ``MlpParams`` tensors only; origins, directions, z, noise and xyz
    get none. ``stash=True``: forward = the stash forward, backward = the
    stash backward; the stash lives from forward to backward and is freed
    there; both take their kernels by shape (``render_variant``,
    ``chain_variant``: wgmma at the served bf16 widths). ``stash=False``:
    forward = the plain forward kernel, which keeps its inputs only;
    backward = the recompute backward, which runs the stash form of the
    same variant again, so both ask for ``recompute_variant``'s kernels
    (wgmma at the served bf16 widths): the recomputed rows are the
    forward's bits."""

    @staticmethod
    def forward(ctx, origins, dirs, z_vals, noise, xyz, opts, *flat):
        (n_emb_xyz, n_emb_dir, compute_dtype, exact_encode, skips, stash,
         slab_rays) = opts
        kw = prepare_kernel_weights(unflatten_params(flat), n_emb_xyz,
                                    n_emb_dir, compute_dtype, skips)
        # no stash: the recompute's variant, whose stash form the backward
        # runs again
        variant = (None if stash
                   else recompute_variant(kw.dims, z_vals.shape[1]))
        out, w_out, st = render_fwd(kw, origins, dirs, z_vals, noise,
                                     exact_encode, stash=stash, xyz=xyz,
                                     variant=variant)
        ctx.kw, ctx.stash = kw, st
        ctx.opts = (exact_encode, stash, slab_rays)
        keep = (None, None) if stash else (origins, xyz)
        ctx.save_for_backward(z_vals, noise, dirs, *keep)
        return out, w_out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ray, g_w):
        z_vals, noise, dirs, origins, xyz = ctx.saved_tensors
        exact_encode, stash, slab_rays = ctx.opts
        if stash and ctx.stash is None:
            raise RuntimeError("the stash was freed by an earlier backward")
        # a cotangent no loss term reads arrives as None
        if g_ray is None:
            ldo = _round_up(ctx.kw.dims["C"] + 1, LANE)
            g_ray = z_vals.new_zeros((z_vals.shape[0], ldo))
        if g_w is None:
            g_w = torch.zeros_like(z_vals)
        if stash:
            grads = fused_render_bwd(ctx.kw, z_vals, noise, dirs, ctx.stash,
                                     g_ray, g_w, exact_encode)
            ctx.stash = None
            ctx.kw = None
        else:
            grads = fused_render_bwd_recompute(
                ctx.kw, origins, dirs, z_vals, noise, g_ray, g_w,
                exact_encode, xyz, slab_rays)
        return (None,) * 6 + flatten_params(grads)


def fused_render_train(
    params: MlpParams,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    z_vals: torch.Tensor,
    noise: torch.Tensor,
    n_emb_xyz: int = 15,
    n_emb_dir: int = 4,
    compute_dtype: torch.dtype = torch.float32,
    exact_encode: bool = True,
    skips: Tuple[int, ...] = (4,),
    xyz: Optional[torch.Tensor] = None,
    stash: bool = True,
    slab_rays: Optional[int] = None,
):
    """Differentiable fused render of one pass -> (ray block, weights) as
    ``fused_render_apply``. ``params`` are live tensors on the autograd
    graph (``mlp_params_from_module(m, detach=False)``): they are laid out
    for the kernel at every call, and the backward kernel's gradients flow
    back onto them. ``xyz`` (N, S, 3): the xyz-in form. ``stash=False``:
    nothing but the inputs lives from forward to backward, and the backward
    recomputes in slabs of ``slab_rays`` rays (default ``slab_rays_for``)."""
    opts = (n_emb_xyz, n_emb_dir, compute_dtype, exact_encode, tuple(skips),
            bool(stash), slab_rays)
    return FusedRenderTrain.apply(
        None if origins is None else origins.detach(), dirs.detach(),
        z_vals.detach(), noise.detach(),
        None if xyz is None else xyz.detach().float().contiguous(), opts,
        *flatten_params(params))
