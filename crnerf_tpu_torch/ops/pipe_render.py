"""The pipelined fused render forward (``csrc/pipe_render_fwd.cu``):
counterpart of ``scripts/spike_interleave.py`` ``pipe_render_apply``, the
TPU kernel that holds several half-tiles of rays in flight per grid step.

It computes exactly the fused render forward's function (K1, rays-in, no
stash): ``pipe_render_apply(kw, origins, dirs, z_vals, noise,
exact_encode=False, phases=2)`` -> (ray block (N,
round_up(C+1, 128)) f32 [fmap | depth | 0], weights (N, S) f32), for
weights laid out by
``ops.fused_render.prepare_kernel_weights``. On the card it has two
kernels, chosen by shape before the launch (``pipe_variant``, K1's
``render_variant``), each with K1's bits at the shapes it takes:

- "wgmma" (``csrc/pipe_render_fwd_wgmma.cuh``; bf16 at the served widths):
  the wgmma K1's persistent CTA whose two consumer warpgroups take turns
  at the tensor cores, one product phase each, so that one warpgroup's
  epilogue, encode and compositing run while the other's products do;
  an item of ``phases`` rays, each warpgroup walking rays of its own
  (``phases`` = 1: the even and odd 64-sample tiles of one ray). It gives
  the wgmma K1's bits.
- "mma" (``csrc/pipe_render_fwd.cu``; other bf16 widths): one CTA takes
  ``phases`` consecutive rays and walks their 64-sample chunks as one
  stream, with the compositing of a chunk on a warp of its own while the
  other eight warps run the next chunk's encode and trunk; the mma.sync
  K1's bits. Shared memory does not depend on ``phases``; a CTA that does
  not fit on an SM at the weights' widths is refused before launch. It is
  built for one CTA an SM: two CTAs of nine warps would cap a thread at 96
  registers and spill K1's trunk (see the kernel's header).

The kernel is bf16 only, as the spike: fp32 weights are refused on the
card. A CPU tensor takes the plain version, ``pipe_render_plain``, which
is K1's plain version ``render_fwd_plain`` under S2's name; any other
device raises. No path of the system calls it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.utils import tracing

# launches of each kernel, counted where it launches
LAUNCH_COUNTS: Dict[str, int] = tracing.register({
    "pipe_render_fwd": 0,       # wgmma
    "pipe_render_fwd_mma": 0})  # mma.sync

PHASES = (1, 2, 4)   # rays per CTA the spike tool and the card checks run

pipe_render_plain = fr.render_fwd_plain

_DIMS = fr._FWD_DIMS + ("P",)
_C_FN = "crnerf_pipe_render_fwd"
_C_FN_WGMMA = "crnerf_pipe_render_fwd_wgmma"


def _lib():
    from crnerf_tpu_torch.ops import _build

    return _build.load("pipe_render_fwd.cu", {
        _C_FN: fr._C_ARGS, _C_FN_WGMMA: fr._C_ARGS,
        "crnerf_pipe_render_occupancy": (ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p)})


def pipe_variant(dims: Dict[str, int]) -> str:
    """S2's kernel for a layout's dimensions: K1's choice
    (``fused_render.render_variant``), "wgmma" at bf16 and the served
    widths, else "mma". The card takes bf16 only."""
    return fr.render_variant(dims)


@functools.lru_cache(maxsize=None)
def _occupancy(dims: Tuple[int, ...], device_index: int) -> int:
    with torch.cuda.device(device_index):
        arr = (ctypes.c_int * len(dims))(*dims)
        blocks = ctypes.c_int(0)
        rc = _lib().crnerf_pipe_render_occupancy(arr, len(dims),
                                                 ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"crnerf_pipe_render_occupancy failed: "
                           f"cudaError {rc}")
    return blocks.value


def pipe_render_occupancy(kw: fr.KernelWeights, device) -> int:
    """CTAs of the kernel one SM holds for these weights' widths
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the same for every
    ``phases``); 0 when one CTA does not fit."""
    dims = dict(kw.dims, N=1, S=1, exact=0, ldo=0, SC=0, P=1)
    return _occupancy(tuple(dims[k] for k in _DIMS),
                      torch.device(device).index or 0)


def pipe_render_apply(
    kw: fr.KernelWeights,
    origins: torch.Tensor,      # (N, 3) ray origins
    dirs: torch.Tensor,         # (N, 3) unit ray directions
    z_vals: torch.Tensor,       # (N, S)
    noise: torch.Tensor,        # (N, S) sigma noise
    exact_encode: bool = False,
    phases: int = 2,
):
    """-> (ray block (N, c_pad) f32, weights (N, S) f32), as
    ``fused_render_apply``; ``phases`` rays a CTA on the card, on
    ``pipe_variant``'s kernel."""
    if phases < 1:
        raise ValueError(f"phases {phases}: need >= 1 rays a CTA")
    if z_vals.device.type == "cpu":
        return pipe_render_plain(kw.params, origins, dirs, z_vals, noise,
                                 kw.n_emb_xyz, kw.n_emb_dir,
                                 kw.compute_dtype, exact_encode, kw.skips)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no pipelined render for device {z_vals.device}")
    if kw.compute_dtype != torch.bfloat16:
        raise ValueError("the pipelined render kernel is bf16 only (the "
                         f"spike runs bf16), got {kw.compute_dtype}")
    if kw.dims["C"] > fr.MAX_C:
        raise ValueError(f"feature width {kw.dims['C']} > {fr.MAX_C}")
    dev = z_vals.device
    n, s = z_vals.shape
    od = fr._check_rays(kw, origins, dirs, z_vals, noise, None)
    variant = pipe_variant(kw.dims)
    if variant == "mma" and pipe_render_occupancy(kw, dev) < 1:
        raise RuntimeError(
            f"the pipelined render's CTA does not fit on an SM at widths "
            f"WP={kw.dims['WP']}, KE={kw.dims['KE']}, CP={kw.dims['CP']} "
            f"(shared memory); use fused_render_apply")
    ldo = fr._round_up(kw.dims["C"] + 1, fr.LANE)
    out = torch.empty((n, ldo), dtype=torch.float32, device=dev)
    w_out = torch.empty((n, s), dtype=torch.float32, device=dev)
    dims = dict(kw.dims, N=n, S=s, exact=int(exact_encode), ldo=ldo,
                SC=fr.grad_layout(kw.dims).sc, P=phases)
    tensors = [od, z_vals, noise, fr.dir_block(kw, dirs, exact_encode), out,
               w_out, None, None, *kw.tensors]
    if variant == "wgmma":
        fr._call(_lib(), _C_FN_WGMMA, tensors + [fr.wgmma_weights(kw)], dims,
                 _DIMS, dev)
        LAUNCH_COUNTS["pipe_render_fwd"] += 1
    else:
        fr._call(_lib(), _C_FN, tensors, dims, _DIMS, dev)
        LAUNCH_COUNTS["pipe_render_fwd_mma"] += 1
    return out, w_out
