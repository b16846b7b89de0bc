"""Elementwise sin and cos as one CUDA kernel (``csrc/sincos.cu``):
counterpart of the Pallas kernel of ``scripts/spike_kernel_sincos.py``,
which measures how accurate in-kernel sin/cos are at the positional
encode's anchor scales.

``sincos(x)`` -> (sin x, cos x), float32, through the same ``sinf`` /
``cosf`` the port's fused kernels use for their encode; ``fast=True``
takes the hardware's ``__sinf`` / ``__cosf`` instead, a variant that is
reported and that no kernel of the port uses. A CPU tensor takes the plain
version (``torch.sin``, ``torch.cos``) whatever ``fast`` says; a CUDA
tensor launches the kernel, any other device raises. No path of the system
calls it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from crnerf_tpu_torch.ops import _build
from crnerf_tpu_torch.utils import tracing

# launches of the kernel (either variant), counted where it launches
LAUNCH_COUNTS: Dict[str, int] = tracing.register({"sincos": 0})

# The accurate variant against float64 at the float32 argument: CUDA's
# sinf / cosf are documented within 2 ulp, and |sin| <= 1, so 2 ulp of 1.0.
# The plain version on the CPU is within 1 ulp of float64 at every scale
# (and within 1 ulp of jnp.sin / jnp.cos), so it meets the same bound.
F64_TOL = 2.0 ** -22

SCALES = (5.0, 5.0 * 2 ** 4, 5.0 * 2 ** 8, 5.0 * 2 ** 11, 5.0 * 2 ** 14)

_C_FN = "crnerf_sincos"
# x, s, c, n, fast, stream
_C_ARGS = {_C_FN: (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)}
# bound at the first launch; later calls take no lock and no lookup
_launch = _build.entry("sincos.cu", _C_ARGS, _C_FN)


def _lib():
    return _build.load("sincos.cu", _C_ARGS)


def sincos_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sin(x), torch.cos(x)


def sincos(x: torch.Tensor,
           fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (sin x, cos x), float32, x's shape."""
    dev = x.device
    if dev.type == "cpu":
        return sincos_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"no sincos kernel for device {dev}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.numel()
    if n == 0:
        raise ValueError("x is empty")
    s, c = torch.empty_like(x), torch.empty_like(x)
    # the current stream's handle, without a device guard
    rc = _launch(x.data_ptr(), s.data_ptr(), c.data_ptr(), n, int(fast),
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"crnerf_sincos launch failed: cudaError {rc}")
    LAUNCH_COUNTS["sincos"] += 1
    return s, c
