"""Fused NeRF-MLP evaluation per sample point: posenc + the 11-layer MLP in
ONE CUDA kernel (``csrc/fused_mlp_fwd.cuh``) and its weight-gradient
backward (``csrc/fused_mlp_bwd.cu``), for callers that need per-point
outputs: the renderer's ``pallas_render=False`` route composites them with
``core.compositing.composite`` under autograd.

Counterpart of ``crnerf_tpu/ops/fused_mlp.py`` ``fused_mlp_apply`` and
``make_fused_mlp_train``. Inputs: points xyz (M, 3) and directions
(M / dir_rep, 3), each direction shared by ``dir_rep`` consecutive points
(``dir_rep`` = samples per ray in the renderer, 1 = a direction per
point). Outputs, both float32:

  features (M, C) in [0, 1]      sigma (M,) >= 0 (softplus)

where the JAX kernel writes one lane-packed block [features | sigma | 0].
Training: the forward keeps nothing but its inputs (the JAX VJP keeps the
encode block). The backward walks the points in slabs of a fixed size; for
each slab it runs the forward again into a scratch stash, then the dz chain
from the per-point cotangents and the split-K weight gradient on it, and
adds the slab's gradients onto those before, in slab order. It returns a
float32 gradient for every weight and bias and nothing for points or
directions. Every sum has a fixed order: two runs give the same bits.

The dtype policy is the JAX fused-MLP kernels', which is NOT the fused
render kernels' (``ops.fused_render``): products take their operands
(activations, weights, dz) at the compute dtype and accumulate in fp32,
ReLU outputs, ``hf`` and ``dd`` are cast to the compute dtype, but the
sigma head runs in fp32 on the unrounded fp32 sigma weights, forward and
backward (the fused render kernels round both to the compute dtype), and
the dir-encode weight gradient is a per-point product with ``ddd`` rounded
per point (the fused render backward sums ``ddd`` per ray first). At fp32
the two policies coincide.

``mlp_apply_plain`` / ``mlp_bwd_plain`` are the plain PyTorch versions with
that policy; ``fused_mlp_apply`` (inference) and ``fused_mlp_train`` (a
``torch.autograd.Function``) are the wrappers: a CPU tensor goes to the
plain versions; a CUDA tensor launches the kernels or raises.

The forward has two kernels for the same function, chosen by shape before
the launch (``mlp_variant``): at bf16 and the served MLPs' widths (WP 256,
HP 128, CP 64) the wgmma kernel (``csrc/fused_mlp_fwd_wgmma.cuh``: the
fused render's wgmma body, TMA-streamed weights, 128-point tiles), else
the mma.sync one. So has the backward (``mlp_bwd_variant``: the wgmma
forward's shape with at most ``WGMMA_CHAIN_MAX_L`` trunk layers): its
wgmma slabs run the wgmma forward's stash instance and the wgmma chain
(``csrc/fused_mlp_bwd_wgmma.cuh``), its mma.sync slabs the mma.sync pair.
The forward of training asks for the backward's variant, whose stash form
the backward recomputes: the recomputed masks are the forward's bits.
Each variant counts its launches apart (``LAUNCH_COUNTS``: the mma.sync
kernels' under ``fused_mlp_fwd_mma`` and ``fused_mlp_bwd_mma``).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from crnerf_tpu_torch.models.nerf_mlp import softplus
from crnerf_tpu_torch.ops.fused_render import LAUNCH_COUNTS as FR_LAUNCH_COUNTS
from crnerf_tpu_torch.ops.fused_render import (
    WGMMA_CHAIN_MAX_L,
    WGMMA_DIR_K,
    WGMMA_KE,
    GradLayout,
    KernelWeights,
    MlpParams,
    _C_ARGS,
    _call,
    _check,
    _chain_grid,
    _chain_weights,
    _mm,
    _round_up,
    _served_widths,
    _sm_count,
    _stream,
    _wgrad_key,
    _wgrad_plan,
    bwd_wgrad_plain,
    dir_block,
    flatten_params,
    grad_layout,
    pack_mma_b,
    prepare_kernel_weights,
    sincos_encode,
    unflatten_params,
    wgmma_chain_weights,
    wgrad_variant,
)
from crnerf_tpu_torch.utils import tracing

# launches of each kernel, counted by its wrapper where it launches
LAUNCH_COUNTS: Dict[str, int] = tracing.register({
    "fused_mlp_fwd": 0,      # forward, wgmma (the served widths, bf16)
    "fused_mlp_fwd_mma": 0,  # forward, mma.sync (fp32, other widths)
    "fused_mlp_bwd": 0,      # recompute backward, wgmma: every slab, one
    "fused_mlp_bwd_mma": 0,  # recompute backward, mma.sync
})

# Scratch of the backward: the slab's stash and dz buffer together stay under
# this many bytes (``slab_points_for``): ~212,000 points at 8x256 bf16
# (10,176 bytes a point), as the fused render's recompute backward.
BWD_SCRATCH_BYTES = 2 << 30

# Kernel against mlp_apply_plain on the same inputs, per compute dtype: max
# abs error of the features (in [0, 1]) and of sigma over max(1, largest
# sigma). fp32: summation order and sin/cos ulps (the JAX package holds its
# kernel to 2e-6 on one CPU; two devices' fp32 sums differ more). bf16: both
# round at the same points, but where an fp32 sum lands on the other side of
# a rounding boundary one activation moves by 2^-8 relative and carries
# through the layers below; a per-point output has no average over samples
# to hide that in, so the bound is one bf16 step at 1.0.
KERNEL_TOL: Dict[torch.dtype, Tuple[float, float]] = {
    torch.float32: (1e-4, 1e-4),
    torch.bfloat16: (4e-3, 4e-3),
}

# The backward kernel against the plain chain and weight gradient on the
# kernel's own recomputed stash (one shared forward): max abs error of each
# gradient tensor over that tensor's largest absolute value. The bounds and
# their reasons are the fused render backward's (``fused_render.GRAD_TOL``).
GRAD_TOL: Dict[torch.dtype, float] = {
    torch.float32: 1e-4,
    torch.bfloat16: 1e-2,
}
# The same from the inputs, each side recomputing its own forward. The
# backward is not continuous in the forward: a ReLU whose input lies within
# the two forwards' difference of zero (fp32: order of sums, sinf against
# torch.sin; bf16: an fp32 sum on the other side of a rounding boundary) is
# open on one side and shut on the other, and each such point moves a
# gradient by one point's whole term. The bounds are the ones the fused
# render's recompute backward is held to from its inputs.
GRAD_TOL_FROM_INPUTS: Dict[torch.dtype, float] = {
    torch.float32: 1e-2,
    torch.bfloat16: 3e-2,
}


class MlpKernelWeights(NamedTuple):
    """Weights laid out for the fused-MLP kernels
    (``prepare_mlp_weights``): the fused render layout plus the two
    operands whose policy differs."""

    kw: KernelWeights
    ws_row: torch.Tensor    # (WP,) sigma weights, fp32, unrounded
    wde: torch.Tensor       # (DKP, HP) dir-encode rows, laid out as a product
    # operand (bf16 in mma fragment order, or fp32 row-major)


def prepare_mlp_weights(params: MlpParams, n_emb_xyz: int = 15,
                        n_emb_dir: int = 4,
                        compute_dtype: torch.dtype = torch.float32,
                        skips: Tuple[int, ...] = (4,)) -> MlpKernelWeights:
    """``prepare_kernel_weights`` and the sigma row in fp32 and the
    dir-encode rows of the direction layer as a matrix-product operand
    (rows padded to 16). A snapshot of ``params``."""
    kw = prepare_kernel_weights(params, n_emb_xyz, n_emb_dir, compute_dtype,
                                skips)
    wde = kw.padded["wde"]
    dkp = _round_up(kw.dims["DK"], 16)
    full = wde.new_zeros((dkp, wde.shape[1]))
    full[:wde.shape[0]] = wde
    lay = pack_mma_b if kw.dims["BF16"] else (lambda m: m)
    return MlpKernelWeights(kw, kw.padded["ws"][:, 0].contiguous(),
                            lay(full))


def mlp_grad_layout(dims: Dict[str, int]) -> GradLayout:
    """The fused render's layout with the per-point dir encode as DKP more
    stash columns (after the encode), its weight gradient as one more job
    in place of the sigma job, and the sigma weight gradient (WP, fp32)
    after the bias sums in the bias vector."""
    return _mlp_grad_layout(grad_layout(dims), dims["WP"], dims["HP"],
                            _round_up(dims["DK"], 16))


@functools.lru_cache(maxsize=None)
def _mlp_grad_layout(base: GradLayout, wp: int, hp: int,
                     dkp: int) -> GradLayout:
    jobs, off = [], 0
    for key, a_col, k, b_col, n, _ in base.jobs + (
            ("wde", base.sc, dkp, base.d_ddd, hp, 0),):
        if key == "ws":
            continue
        jobs.append((key, a_col, k, b_col, n, off))
        off += k * n
    return base._replace(sc=base.sc + dkp, bt=base.dc + wp, wt=off,
                         jobs=tuple(jobs))


def unpack_mlp_grads(mkw: MlpKernelWeights, gw: torch.Tensor,
                     gb: torch.Tensor) -> MlpParams:
    """Flat padded gradients (``mlp_grad_layout``) -> gradients in the
    layout of ``MlpParams``; padded units are dropped (exactly zero)."""
    kw = mkw.kw
    lay = mlp_grad_layout(kw.dims)
    p = kw.params
    width, half = p.final_w.shape[0], p.dir_w.shape[1]
    c, d_xyz = p.feat_w.shape[1], 3 + 6 * kw.n_emb_xyz
    wp, dk = kw.dims["WP"], kw.dims["DK"]
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
    return MlpParams(
        trunk_w=tuple(trunk_w), trunk_b=tuple(trunk_b),
        sigma_w=gb[lay.dc:lay.dc + width].reshape(width, 1),
        sigma_b=gb[lay.d_sig:lay.d_sig + 1],
        final_w=blocks["wf"][:width, :width],
        final_b=gb[lay.d_hf:lay.d_hf + width],
        dir_w=torch.cat([blocks["wdh"][:width, :half],
                         blocks["wde"][:dk, :half]], 0),
        dir_b=gb[lay.d_ddd:lay.d_ddd + half],
        feat_w=blocks["wc"][:half, :c],
        feat_b=gb[lay.d_feat:lay.d_feat + c],
    )


def mlp_variant(dims: Dict[str, int]) -> str:
    """The inference forward's kernel for a layout's dimensions: "wgmma"
    at bf16 and the one width it is built for, the served MLPs' (WP 256,
    HP 128, CP 64, the encode within ``WGMMA_KE`` columns and the
    direction's within ``WGMMA_DIR_K``), else "mma". A function of the
    shapes alone, taken before the launch."""
    fits = (_served_widths(dims) and 3 + 6 * dims["F"] <= WGMMA_KE
            and dims["DK"] <= WGMMA_DIR_K)
    return "wgmma" if fits else "mma"


def mlp_bwd_variant(dims: Dict[str, int]) -> str:
    """The backward's kernels for a layout's dimensions, and so the
    training forward's, whose bits the backward's slabs recompute: "wgmma"
    (the wgmma forward's stash instance and the wgmma chain a slab) where
    the wgmma forward takes the shape (``mlp_variant``) and the trunk has
    at most ``WGMMA_CHAIN_MAX_L`` layers (the chain's sums' shared
    memory), else "mma" (the mma.sync pair, forward included)."""
    fits = mlp_variant(dims) == "wgmma" and dims["L"] <= WGMMA_CHAIN_MAX_L
    return "wgmma" if fits else "mma"


def _pick(variant: Optional[str], chosen: str, what: str, dims) -> str:
    """``variant`` checked against the shape's choice: None takes it;
    "wgmma" raises where the shape does not take the wgmma kernels."""
    variant = chosen if variant is None else variant
    if variant not in ("wgmma", "mma"):
        raise ValueError(f"variant {variant!r}: 'wgmma' or 'mma'")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma fused MLP {what} does not take dims "
                         f"{dims}")
    return variant


def wgmma_mlp_weights(mkw: MlpKernelWeights) -> torch.Tensor:
    """The wgmma forward's weight stream (``fused_render._stream_index``,
    form "mlp": the trunk, the final layer, the dir layer's hidden rows
    and its dir-encode rows as one more slice, the feature head), gathered
    at its first use in one indexing launch and kept with the layout."""
    return _stream(mkw.kw, "mlp")


# ------------------------------------------------------------ plain forward
def _dims_check(xyz: torch.Tensor, dirs: torch.Tensor, dir_rep: int,
                p_base: int = 0) -> int:
    """-> M. The directions cover the points: exactly with ``p_base`` 0;
    else point p's is dirs[(p_base + p) // dir_rep], which must exist."""
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.shape[0] == 0:
        raise ValueError(f"xyz must be (M, 3), M >= 1, got "
                         f"{tuple(xyz.shape)}")
    m = xyz.shape[0]
    n_dirs = dirs.shape[0] if dirs.dim() == 2 else 0
    covered = (n_dirs * dir_rep == m if p_base == 0
               else n_dirs * dir_rep >= p_base + m)
    if dir_rep < 1 or p_base < 0 or dirs.dim() != 2 or dirs.shape[1] != 3 \
            or not covered:
        raise ValueError(f"dirs {tuple(dirs.shape)} x dir_rep {dir_rep} "
                         f"does not cover {m} points from {p_base}")
    return m


def mlp_fwd_plain(mkw: MlpKernelWeights, xyz, dirs,
                  exact_encode: bool = True, dir_rep: int = 1,
                  stash: bool = False, p_base: int = 0):
    """Plain PyTorch version of the forward kernel on laid-out weights ->
    (features (M, C) f32, sigma (M,) f32), and with ``stash`` also the
    activation stash (M, SC) at the compute dtype in the kernel's layout
    (``mlp_grad_layout``). ``p_base``: the index of xyz[0] among the
    points ``dirs`` cover (point p's direction is dirs[(p_base + p) //
    dir_rep])."""
    kw = mkw.kw
    params, dt = kw.params, kw.compute_dtype
    m = _dims_check(xyz, dirs, dir_rep, p_base)
    enc = sincos_encode(xyz.float(), kw.n_emb_xyz, exact_encode)
    d_xyz = enc.shape[1]
    first = p_base // dir_rep
    denc = dir_block(kw, dirs[first:-(-(p_base + m) // dir_rep)],
                     exact_encode).repeat_interleave(dir_rep, 0)
    denc = denc[p_base - first * dir_rep:p_base - first * dir_rep + m]
    h = None
    acts = []
    for i, (w, b) in enumerate(zip(params.trunk_w, params.trunk_b)):
        if i == 0:
            acc = _mm(enc, w, dt)
        elif i in kw.skips:
            acc = _mm(enc, w[:d_xyz], dt) + _mm(h, w[d_xyz:], dt)
        else:
            acc = _mm(h, w, dt)
        h = torch.relu(acc + b).to(dt)
        acts.append(h)
    # the sigma head in fp32 on the unrounded weights
    z_sig = h.float() @ params.sigma_w.float() + params.sigma_b
    hf = (_mm(h, params.final_w, dt) + params.final_b).to(dt)
    width = params.final_w.shape[0]
    zd = (_mm(hf, params.dir_w[:width], dt)
          + _mm(denc, params.dir_w[width:], dt) + params.dir_b)
    dd = torch.relu(zd).to(dt)
    feat = torch.sigmoid(_mm(dd, params.feat_w, dt) + params.feat_b)
    sigma = softplus(z_sig[:, 0])
    if not stash:
        return feat, sigma
    lay = mlp_grad_layout(kw.dims)
    wp = kw.dims["WP"]
    st = torch.zeros((m, lay.sc), dtype=dt, device=xyz.device)
    for i, a in enumerate(acts):
        st[:, i * wp:i * wp + width] = a
    st[:, lay.o_hf:lay.o_hf + width] = hf
    st[:, lay.o_dd:lay.o_dd + dd.shape[1]] = dd
    st[:, lay.o_enc:lay.o_enc + d_xyz] = enc.to(dt)
    o_dir = lay.o_enc + kw.dims["KE"]
    st[:, o_dir:o_dir + denc.shape[1]] = denc.to(dt)
    return feat, sigma, st


def mlp_apply_plain(params: MlpParams, xyz, dirs, n_emb_xyz: int = 15,
                    n_emb_dir: int = 4,
                    compute_dtype: torch.dtype = torch.float32,
                    exact_encode: bool = True,
                    skips: Tuple[int, ...] = (4,), dir_rep: int = 1):
    """Plain PyTorch version of the forward kernel: xyz (M, 3), dirs
    (M / dir_rep, 3) -> (features (M, C), sigma (M,)), float32."""
    mkw = prepare_mlp_weights(params, n_emb_xyz, n_emb_dir, compute_dtype,
                              skips)
    return mlp_fwd_plain(mkw, xyz, dirs, exact_encode, dir_rep)


# ----------------------------------------------------------- plain backward
def mlp_chain_plain(mkw: MlpKernelWeights, stash, g_feat, g_sigma):
    """Plain version of the backward's chain kernel: the per-point
    cotangents and the stash -> (dz buffer (M, DC) at the compute dtype,
    bias sums and sigma weight gradient (BT,) f32). An explicit backward
    that rounds where the JAX kernel rounds: every product operand, dz
    included, at the compute dtype with fp32 sums; the bias sums from the
    unrounded dz; the sigma branch in fp32 throughout."""
    kw = mkw.kw
    dims, pad, dt = kw.dims, kw.padded, kw.compute_dtype
    n_layers, wp, hp, cp, c = (dims["L"], dims["WP"], dims["HP"], dims["CP"],
                               dims["C"])
    lay = mlp_grad_layout(dims)
    m = stash.shape[0]
    r = lambda x: x.to(dt).float()                 # noqa: E731
    mm = lambda a, w: r(a) @ r(w)                  # noqa: E731
    mm_bt = lambda dz, w: r(dz) @ r(w).T           # noqa: E731
    st = stash.float()
    h = [st[:, i * wp:(i + 1) * wp] for i in range(n_layers)]
    dd = st[:, lay.o_dd:lay.o_dd + hp]
    z_sig = h[-1] @ mkw.ws_row[:, None] + pad["bs"][:1]
    feat = torch.sigmoid(mm(dd, pad["wc"]) + pad["bc"])
    dfeat = torch.zeros((m, cp), dtype=torch.float32, device=stash.device)
    dfeat[:, :c] = g_feat
    dz = {}
    dz["feat"] = dfeat * feat * (1.0 - feat)
    dz["ddd"] = torch.where(dd > 0, mm_bt(dz["feat"], pad["wc"]),
                            torch.zeros_like(dd))
    dz["hf"] = mm_bt(dz["ddd"], pad["wdh"])
    dz_sig = g_sigma.reshape(-1, 1) * torch.sigmoid(z_sig)
    g_ws = h[-1].T @ dz_sig
    dh = mm_bt(dz["hf"], pad["wf"]) + dz_sig * mkw.ws_row[None]
    for i in range(n_layers - 1, -1, -1):
        dz[i] = torch.where(h[i] > 0, dh, torch.zeros_like(dh))
        if i > 0:
            dh = mm_bt(dz[i], pad["wh", i])
    sig_blk = torch.zeros((m, 32), dtype=torch.float32, device=stash.device)
    sig_blk[:, :1] = dz_sig
    full = torch.cat([dz[i] for i in range(n_layers)]
                     + [dz["hf"], sig_blk, dz["ddd"], dz["feat"]], 1)
    return full.to(dt), torch.cat([full.sum(0), g_ws[:, 0]])


def slab_points_for(mkw: MlpKernelWeights, m: int, device=None,
                    budget: int = BWD_SCRATCH_BYTES,
                    variant: Optional[str] = None) -> int:
    """Points per slab of the backward over m points: as many as keep the
    slab's stash and dz buffer under ``budget`` bytes, whatever m is; on a
    card, a whole number of the chain kernel's waves when it is more than
    one: the mma.sync chain's grids of 64-point tiles, or for the wgmma
    variant (``variant``, default ``mlp_bwd_variant``'s) the wgmma
    kernels' waves of 128-point tiles, one CTA an SM."""
    kw = mkw.kw
    lay = mlp_grad_layout(kw.dims)
    per_point = (lay.sc + lay.dc) * (2 if kw.dims["BF16"] else 4)
    p = max(1, budget // per_point)
    if p >= m:
        return m
    if device is not None and torch.device(device).type == "cuda":
        if (variant or mlp_bwd_variant(kw.dims)) == "wgmma":
            wave = 128 * _sm_count(device)
        else:
            wave = 64 * _chain_grid(kw, p, device)[0]
        if p > wave:
            p -= p % wave
    return p


def mlp_bwd_slabs_plain(mkw: MlpKernelWeights, xyz, dirs, g_feat, g_sigma,
                        exact_encode: bool = True, dir_rep: int = 1,
                        slab_points: Optional[int] = None):
    """Plain version of the backward: slab by slab the stash forward
    again, the chain and the weight gradient, each slab's flat padded
    gradients added onto the slabs before in slab order -> (gw (WT,), gb
    (BT,), the last slab's (stash, dz buffer))."""
    kw = mkw.kw
    m = _dims_check(xyz, dirs, dir_rep)
    lay = mlp_grad_layout(kw.dims)
    p = min(m, slab_points or slab_points_for(mkw, m))
    # one direction per point of the slab: a slab may start inside a ray
    dirs_pt = dirs.repeat_interleave(dir_rep, 0) if dir_rep > 1 else dirs
    gw = gb = scratch = None
    for p0 in range(0, m, p):
        sl = slice(p0, p0 + p)
        _, _, st = mlp_fwd_plain(mkw, xyz[sl], dirs_pt[sl], exact_encode, 1,
                                 stash=True)
        dzbuf, gb_s = mlp_chain_plain(mkw, st, g_feat[sl], g_sigma[sl])
        gw_s = bwd_wgrad_plain(kw, st, dzbuf, lay)
        gw = gw_s if gw is None else gw + gw_s
        gb = gb_s if gb is None else gb + gb_s
        scratch = (st, dzbuf)
    return gw, gb, scratch


def mlp_bwd_plain(params: MlpParams, xyz, dirs, g_feat, g_sigma,
                  n_emb_xyz: int = 15, n_emb_dir: int = 4,
                  compute_dtype: torch.dtype = torch.float32,
                  exact_encode: bool = True, skips: Tuple[int, ...] = (4,),
                  dir_rep: int = 1,
                  slab_points: Optional[int] = None) -> MlpParams:
    """Plain PyTorch version of the backward kernel: the forward's inputs
    and the cotangents of the features (M, C) and of sigma (M,) -> a
    float32 gradient for every tensor of ``params``."""
    mkw = prepare_mlp_weights(params, n_emb_xyz, n_emb_dir, compute_dtype,
                              skips)
    gw, gb, _ = mlp_bwd_slabs_plain(mkw, xyz, dirs, g_feat, g_sigma,
                                    exact_encode, dir_rep, slab_points)
    return unpack_mlp_grads(mkw, gw, gb)


# ------------------------------------------------------------------ wrappers
_FWD_DIMS = ("M", "R", "p_base", "L", "skip_mask", "WP", "HP", "CP", "C",
             "KE", "F", "DK", "DKP", "exact", "BF16", "SC")
_BWD_DIMS = ("M", "R", "L", "skip_mask", "WP", "HP", "CP", "C", "KE", "F",
             "DK", "DKP", "exact", "BF16", "SC", "DC", "grid", "WT",
             "n_tiles", "splits", "m_per", "P", "WK")


def _lib_fwd():
    from crnerf_tpu_torch.ops import _build

    return _build.load("fused_mlp_fwd.cu", {"crnerf_mlp_fwd": _C_ARGS,
                                            "crnerf_mlp_fwd_wgmma": _C_ARGS})


def _lib_bwd():
    from crnerf_tpu_torch.ops import _build

    return _build.load("fused_mlp_bwd.cu", {"crnerf_mlp_bwd": _C_ARGS,
                                            "crnerf_mlp_bwd_wgmma": _C_ARGS})


def _fwd_weights(mkw: MlpKernelWeights):
    """The forward's weight operands in its C pointer order: the fused
    render's, with the fp32 sigma row and the dir-encode operand."""
    t = mkw.kw.tensors
    return [mkw.ws_row, *t[1:6], mkw.wde, *t[7:]]


def _check_points(mkw: MlpKernelWeights, xyz, dirs, dir_rep: int,
                  p_base: int = 0):
    """The inputs on one CUDA device -> (M, device)."""
    m = _dims_check(xyz, dirs, dir_rep, p_base)
    dev = xyz.device
    _check("xyz", xyz, (m, 3), dev)
    _check("dirs", dirs, (dirs.shape[0], 3), dev)
    for t in (mkw.ws_row, mkw.wde, *mkw.kw.tensors):
        if t is not None and t.device != dev:
            raise ValueError(f"kernel weights on {t.device}, points on {dev}")
    return m, dev


def mlp_fwd(mkw: MlpKernelWeights, xyz, dirs, exact_encode: bool = True,
            dir_rep: int = 1, p_base: int = 0,
            variant: Optional[str] = None, stash: bool = False):
    """-> (features (M, C) f32, sigma (M,) f32), and with ``stash`` also
    the stash (M, SC) at the compute dtype (``mlp_grad_layout``): the
    plain version for CPU tensors, the kernel for CUDA tensors (the stash
    from its stash instance, which the backward's slabs run). ``p_base``:
    the index of xyz[0] among the points ``dirs`` cover (point p's
    direction is dirs[(p_base + p) // dir_rep]). ``variant``: the kernel,
    "wgmma" or "mma"; None takes ``mlp_variant``'s by shape. The forward
    of training names ``mlp_bwd_variant``'s, and the checks that compare
    the two kernels name theirs; "wgmma" raises where that kernel does not
    take the shape."""
    kw = mkw.kw
    variant = _pick(variant, mlp_variant(kw.dims), "forward", kw.dims)
    if xyz.device.type == "cpu":
        return mlp_fwd_plain(mkw, xyz, dirs, exact_encode, dir_rep,
                             stash=stash, p_base=p_base)
    if xyz.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {xyz.device}")
    m, dev = _check_points(mkw, xyz, dirs, dir_rep, p_base)
    lay = mlp_grad_layout(kw.dims)
    feat = torch.empty((m, kw.dims["C"]), dtype=torch.float32, device=dev)
    sigma = torch.empty((m,), dtype=torch.float32, device=dev)
    st = (torch.empty((m, lay.sc), dtype=kw.compute_dtype, device=dev)
          if stash else None)
    dims = dict(kw.dims, M=m, R=dir_rep, p_base=p_base,
                DKP=_round_up(kw.dims["DK"], 16), exact=int(exact_encode),
                SC=lay.sc)
    tensors = [xyz, dir_block(kw, dirs, exact_encode), feat, sigma, st,
               *_fwd_weights(mkw)]
    if variant == "wgmma":
        _call(_lib_fwd(), "crnerf_mlp_fwd_wgmma",
              tensors + [wgmma_mlp_weights(mkw)], dims, _FWD_DIMS, dev)
        LAUNCH_COUNTS["fused_mlp_fwd"] += 1
    else:
        _call(_lib_fwd(), "crnerf_mlp_fwd", tensors, dims, _FWD_DIMS, dev)
        LAUNCH_COUNTS["fused_mlp_fwd_mma"] += 1
    return (feat, sigma, st) if stash else (feat, sigma)


def fused_mlp_apply(
    mkw: MlpKernelWeights,
    xyz: torch.Tensor,          # (M, 3) sample points
    dirs: torch.Tensor,         # (M / dir_rep, 3) unit directions
    exact_encode: bool = True,
    dir_rep: int = 1,
):
    """-> (features (M, C) f32 in [0, 1], sigma (M,) f32 >= 0) for weights
    laid out by ``prepare_mlp_weights`` (which fixes the compute dtype,
    frequencies and skips). CPU tensors take ``mlp_fwd_plain``; CUDA
    tensors launch ``mlp_variant``'s kernel: the wgmma one at the served
    bf16 widths. No gradient: training goes through ``fused_mlp_train``."""
    return mlp_fwd(mkw, xyz, dirs, exact_encode, dir_rep)


def mlp_bwd(mkw: MlpKernelWeights, xyz, dirs, g_feat, g_sigma,
            exact_encode: bool = True, dir_rep: int = 1,
            slab_points: Optional[int] = None,
            variant: Optional[str] = None):
    """The backward kernel (``mlp_bwd_slabs_plain`` on CPU tensors) -> (gw
    (WT,), gb (BT,), the scratch (stash, dz buffer) as the last slab left
    it). One call walks every slab; the scratch holds ``slab_points``
    points (default ``slab_points_for``) whatever M is. ``variant``: the
    kernels, "wgmma" or "mma"; None takes ``mlp_bwd_variant``'s by shape;
    "wgmma" raises where those kernels do not take the shape."""
    kw = mkw.kw
    variant = _pick(variant, mlp_bwd_variant(kw.dims), "backward", kw.dims)
    if xyz.device.type == "cpu":
        return mlp_bwd_slabs_plain(mkw, xyz, dirs, g_feat, g_sigma,
                                   exact_encode, dir_rep, slab_points)
    if xyz.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {xyz.device}")
    dt = kw.compute_dtype
    m, dev = _check_points(mkw, xyz, dirs, dir_rep)
    lay = mlp_grad_layout(kw.dims)
    _check("g_feat", g_feat, (m, kw.dims["C"]), dev)
    _check("g_sigma", g_sigma, (m,), dev)
    p = min(m, slab_points
            or slab_points_for(mkw, m, dev, variant=variant))
    if p < 1:
        raise ValueError(f"slab of {p} points")
    if variant == "wgmma":
        grid = min(-(-p // 128), _sm_count(dev))
    else:
        grid = min(-(-p // 64), _chain_grid(kw, p, dev)[0])
    tiles, splits, m_per, wk = _wgrad_plan(kw, p, dev, lay)
    stash = torch.empty((p, lay.sc), dtype=dt, device=dev)
    dzbuf = torch.empty((p, lay.dc), dtype=dt, device=dev)
    bpart = torch.empty((grid, lay.bt), dtype=torch.float32, device=dev)
    part = torch.empty((splits, lay.wt), dtype=torch.float32, device=dev)
    gw = torch.empty((lay.wt,), dtype=torch.float32, device=dev)
    gb = torch.empty((lay.bt,), dtype=torch.float32, device=dev)
    dims = dict(kw.dims, M=m, R=dir_rep, DKP=_round_up(kw.dims["DK"], 16),
                exact=int(exact_encode), SC=lay.sc, DC=lay.dc, grid=grid,
                WT=lay.wt, n_tiles=tiles.shape[0], splits=splits,
                m_per=m_per, P=p, WK=wk)
    head = [xyz, dir_block(kw, dirs, exact_encode), g_feat, g_sigma, stash,
            dzbuf, bpart, gb, tiles, part, gw]
    if variant == "wgmma":
        _call(_lib_bwd(), "crnerf_mlp_bwd_wgmma",
              head + [wgmma_chain_weights(kw), wgmma_mlp_weights(mkw),
                      *_fwd_weights(mkw)], dims, _BWD_DIMS, dev)
        LAUNCH_COUNTS["fused_mlp_bwd"] += 1
    else:
        _call(_lib_bwd(), "crnerf_mlp_bwd",
              head + [*_chain_weights(kw)[1:], *_fwd_weights(mkw)], dims,
              _BWD_DIMS, dev)
        LAUNCH_COUNTS["fused_mlp_bwd_mma"] += 1
    # the weight gradient, one launch a slab inside the entry
    FR_LAUNCH_COUNTS[_wgrad_key(wgrad_variant(kw.dims))] += -(-m // p)
    return gw, gb, (stash, dzbuf)


def fused_mlp_bwd(mkw: MlpKernelWeights, xyz, dirs, g_feat, g_sigma,
                  exact_encode: bool = True, dir_rep: int = 1,
                  slab_points: Optional[int] = None) -> MlpParams:
    """Gradients of every tensor of ``mkw.kw.params`` from the forward's
    inputs and the per-point cotangents: the backward kernels of
    ``mlp_bwd_variant`` on CUDA tensors, their plain version on CPU
    tensors."""
    gw, gb, _ = mlp_bwd(mkw, xyz, dirs, g_feat.float().contiguous(),
                        g_sigma.float().contiguous(), exact_encode, dir_rep,
                        slab_points)
    return unpack_mlp_grads(mkw, gw, gb)


class FusedMlpTrain(torch.autograd.Function):
    """Counterpart of ``make_fused_mlp_train``. Gradients come back for the
    ``MlpParams`` tensors only; points and directions get none. Nothing
    but the inputs lives from forward to backward. The forward asks for
    the backward's variant (``mlp_bwd_variant``: at bf16 and the served
    widths with at most ``WGMMA_CHAIN_MAX_L`` trunk layers the wgmma
    forward, else the mma.sync one), whose stash form the backward
    recomputes: the recomputed masks are the forward's bits."""

    @staticmethod
    def forward(ctx, xyz, dirs, opts, *flat):
        (n_emb_xyz, n_emb_dir, compute_dtype, exact_encode, skips, dir_rep,
         slab_points) = opts
        mkw = prepare_mlp_weights(unflatten_params(flat), n_emb_xyz,
                                  n_emb_dir, compute_dtype, skips)
        feat, sigma = mlp_fwd(mkw, xyz, dirs, exact_encode, dir_rep,
                              variant=mlp_bwd_variant(mkw.kw.dims))
        ctx.mkw = mkw
        ctx.opts = (exact_encode, dir_rep, slab_points)
        ctx.save_for_backward(xyz, dirs)
        return feat, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_feat, g_sigma):
        xyz, dirs = ctx.saved_tensors
        exact_encode, dir_rep, slab_points = ctx.opts
        m, c = xyz.shape[0], ctx.mkw.kw.dims["C"]
        # a cotangent no loss term reads arrives as None
        if g_feat is None:
            g_feat = xyz.new_zeros((m, c))
        if g_sigma is None:
            g_sigma = xyz.new_zeros((m,))
        grads = fused_mlp_bwd(ctx.mkw, xyz, dirs, g_feat, g_sigma,
                              exact_encode, dir_rep, slab_points)
        return (None,) * 3 + flatten_params(grads)


def fused_mlp_train(
    params: MlpParams,
    xyz: torch.Tensor,
    dirs: torch.Tensor,
    n_emb_xyz: int = 15,
    n_emb_dir: int = 4,
    compute_dtype: torch.dtype = torch.float32,
    exact_encode: bool = True,
    skips: Tuple[int, ...] = (4,),
    dir_rep: int = 1,
    slab_points: Optional[int] = None,
):
    """Differentiable fused MLP -> (features, sigma) as
    ``fused_mlp_apply``. ``params`` are live tensors on the autograd graph
    (``mlp_params_from_module(m, detach=False)``): they are laid out for the
    kernel at every call, and the backward kernel's gradients flow back
    onto them. The backward recomputes in slabs of ``slab_points`` points
    (default ``slab_points_for``)."""
    opts = (n_emb_xyz, n_emb_dir, compute_dtype, exact_encode, tuple(skips),
            int(dir_rep), slab_points)
    return FusedMlpTrain.apply(xyz.detach().float().contiguous(),
                               dirs.detach().float().contiguous(), opts,
                               *flatten_params(params))
