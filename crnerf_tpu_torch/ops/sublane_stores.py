"""The encode-block assembly before one product, as one CUDA kernel
(``csrc/sublane_stores.cu``): counterpart of the Pallas kernel of
``scripts/spike_sublane_stores.py``, which asks what building a (96, T)
encode block from (3, T) row pieces costs beside the product that reads it.

``sublane_stores(x, w, mode)``: x (tiles * 8, T = 512) float32, w (96, 256)
bfloat16 -> (tiles * 512, 256) float32. Tile i's block ``blk`` (96, 512) is
built from x[8i : 8i + 8] in one of ``MODES``:

- ``base``: rows 0-7 = x, rows 8-95 zero;
- ``stores``: 15 double-angle steps s, c <- 2sc, 1 - 2s^2 on s = x[0:3],
  c = x[3:6]; after step k, s in rows 3k..3k+2 and c in rows 45+3k..47+3k;
  x[0:3] in rows 90-92, rows 93-95 zero;
- ``dmatrix``: sin(D x) with D[r, k] = 0.01 r for every k, the sum in fp32;

and its output rows are blk^T @ w with the block rounded to bf16 and the
products summed in fp32. The TPU kernel leaves the rows this description
calls zero as its scratch held them (rows 8-95 in ``base``, 93-95 in
``stores``) and sums the ``dmatrix`` product at its default precision
(bf16 passes); the port writes zeros and sums in fp32.

The recurrence is stable only on real (sin t, cos t) states in x's rows
0-5; on the spike's own N(0, 1) inputs it overflows to inf / NaN within 15
steps, in the kernel and the plain version alike (fine for timing). A CPU
tensor takes the plain version, ``sublane_stores_plain``; a CUDA tensor
launches the kernel, any other device raises. No path of the system calls
it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from crnerf_tpu_torch.ops.fused_render import pack_mma_b

T = 512        # columns of a tile
ROWS = 96      # rows of a block
N_OUT = 256    # columns of w and of the output
STEPS = 15     # double-angle steps of ``stores``
MODES = ("base", "stores", "dmatrix")

# launches of the kernel (any mode), counted where it launches
LAUNCH_COUNTS: Dict[str, int] = {"sublane_stores": 0}

# Kernel against the plain version on the same inputs, per mode.
# BLOCK_TOL: the kernel's bf16 blocks (``kernel_blocks``) against the plain
# blocks rounded to bf16, max abs difference. ``base`` and ``stores`` build
# them with the same roundings in the same order (the recurrence's products
# rounded apart, as the plain version's elementwise ops take them): the
# same bits. ``dmatrix``'s ``sinf`` may sit an ulp from torch.sin and round
# to the other bf16 neighbour: one bf16 step of a value below 1.
# KERNEL_TOL: the outputs, max abs error over the plain version's largest
# |value|. On the same blocks the fp32 sums of 96 exact bf16 products differ
# in order only (measured <= 3.8e-7 in every mode on an H100, PERF.md
# section 6); ``dmatrix`` adds one bf16 step for a neighbour flip. A
# recurrence that fused its products into FMAs loses the blocks' bits and
# moves the output by over 100 times ``stores``'s limit
# (tests/test_torch_sublane_stores.py).
BLOCK_TOL: Dict[str, float] = {"base": 0.0, "stores": 0.0,
                               "dmatrix": 2.0 ** -8}
KERNEL_TOL: Dict[str, float] = {"base": 1e-5, "stores": 1e-5,
                                "dmatrix": 2.0 ** -7 + 1e-5}

_C_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p)


def _lib():
    from crnerf_tpu_torch.ops import _build

    return _build.load("sublane_stores.cu",
                       {"crnerf_sublane_stores": _C_ARGS})


def sublane_blocks_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x (tiles * 8, T) f32 -> the blocks (tiles, 96, T) f32, before their
    rounding to bf16. Every product is rounded as the kernel rounds it, no
    fused multiply-add: the recurrence's (2s)c and 1 - (2s)s, and the
    dmatrix sum, taken over k = 0..7 in order."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    xt = x.float().reshape(-1, 8, x.shape[-1])
    blk = xt.new_zeros((xt.shape[0], ROWS, xt.shape[-1]))
    if mode == "base":
        blk[:, :8] = xt
    elif mode == "stores":
        s, c = xt[:, 0:3], xt[:, 3:6]
        for k in range(STEPS):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            blk[:, 3 * k:3 * k + 3] = s
            blk[:, 45 + 3 * k:48 + 3 * k] = c
        blk[:, 90:93] = xt[:, 0:3]
    else:
        d = (torch.arange(ROWS, dtype=torch.float32, device=x.device)
             * 0.01)[:, None]
        args = torch.zeros_like(blk)
        for k in range(8):
            args = args + d * xt[:, k:k + 1]
        blk = torch.sin(args)
    return blk


def sublane_stores_plain(x: torch.Tensor, w: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """Plain version: the blocks rounded to bf16, then the fp32 product of
    the bf16-valued operands -> (tiles * T, 256) f32."""
    blk = sublane_blocks_plain(x, mode).to(torch.bfloat16).float()
    out = blk.transpose(1, 2) @ w.to(torch.bfloat16).float()
    return out.reshape(-1, w.shape[1])


def kernel_blocks(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The blocks (tiles, 96, T) f32 that ``sublane_stores`` builds from x,
    bf16-valued, read back through its product with w = [I | 0]: each
    output then sums one block entry times 1 and zeros, which is exact."""
    eye = torch.zeros((ROWS, N_OUT), dtype=torch.bfloat16, device=x.device)
    eye[:, :ROWS] = torch.eye(ROWS, dtype=torch.bfloat16, device=x.device)
    out = sublane_stores(x, eye, mode)
    return out.reshape(-1, x.shape[-1], N_OUT)[..., :ROWS].transpose(1, 2)


def sublane_stores(x: torch.Tensor, w: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """x (tiles * 8, 512) float32, w (96, 256) bfloat16 -> (tiles * 512,
    256) float32 (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = x.device
    if dev.type == "cpu":
        return sublane_stores_plain(x, w, mode)
    if dev.type != "cuda":
        raise ValueError(f"no sublane-stores kernel for device {dev}")
    if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise ValueError(f"x must be float32 and w bfloat16, got {x.dtype} "
                         f"and {w.dtype}")
    if w.device != dev:
        raise ValueError(f"w on {w.device}, x on {dev}")
    if x.dim() != 2 or x.shape[1] != T or x.shape[0] % 8 or x.shape[0] == 0:
        raise ValueError(f"x shape {tuple(x.shape)}: need (tiles * 8, {T}), "
                         "tiles >= 1")
    if tuple(w.shape) != (ROWS, N_OUT):
        raise ValueError(f"w shape {tuple(w.shape)} != {(ROWS, N_OUT)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    tiles = x.shape[0] // 8
    wp = pack_mma_b(w)
    out = torch.empty((tiles * T, N_OUT), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 3)(x.data_ptr(), wp.data_ptr(), out.data_ptr())
    rc = _lib().crnerf_sublane_stores(
        ptrs, 3, tiles, MODES.index(mode),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crnerf_sublane_stores launch failed: cudaError "
                           f"{rc}")
    LAUNCH_COUNTS["sublane_stores"] += 1
    return out
