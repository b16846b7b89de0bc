"""Deterministic alpha compositing as one CUDA kernel
(``csrc/composite.cu``): counterpart of ``crnerf_tpu/ops/composite.py``
``composite_pallas``.

features (N, S, C), sigmas (N, S), z_vals (N, S) -> weights (N, S), feature
map (N, C), depth (N,), all float32: sigma clamped at 0, last delta 1e2,
alpha = 1 - exp(-delta * sigma), weights = alpha * exclusive running
product of (1 - alpha), outputs the weighted sums. No noise and no gradient
(evaluation only): training composites inside the fused render kernels or
through ``core.compositing.composite``, which is differentiable and is this
kernel's plain version. As in the JAX package no path of the system calls
it; it is an exported op.

``composite_apply`` is the wrapper: CPU tensors go to the plain version,
CUDA tensors launch the kernel, any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from crnerf_tpu_torch.core.compositing import composite
from crnerf_tpu_torch.utils import tracing

MAX_C = 256         # channels the kernel takes (8 a lane)

# launches of the kernel, counted by its wrapper where it launches
LAUNCH_COUNTS: Dict[str, int] = tracing.register({"composite": 0})

# Kernel against ``composite`` on the same inputs, max abs error of weights
# and feature map (both in [0, 1]) and of depth (z up to ~6): the two take
# the running product and the sums over S in another order, in float32.
# The feature map is a sum of S terms on both sides: 1e-6 holds up to a few
# dozen samples (the JAX package's test has 20); at S = 512 the two float32
# sums measured 1.5e-6 apart on an H100, so the bound is 4e-6, and
# ``KERNEL_TOL_F64`` holds the kernel to a float64 evaluation more tightly.
KERNEL_TOL: Tuple[float, float, float] = (1e-6, 4e-6, 1e-5)
# Kernel against ``composite`` evaluated at float64 on the same inputs.
KERNEL_TOL_F64: Tuple[float, float, float] = (1e-6, 1e-6, 1e-5)

_C_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p)


def _lib():
    from crnerf_tpu_torch.ops import _build

    return _build.load("composite.cu", {"crnerf_composite": _C_ARGS})


def composite_apply(features: torch.Tensor, sigmas: torch.Tensor,
                    z_vals: torch.Tensor):
    """-> (weights (N, S), feature_map (N, C), depth (N,)) f32."""
    dev = features.device
    if dev.type == "cpu":
        return composite(features.float(), sigmas.float(), z_vals.float())
    if dev.type != "cuda":
        raise ValueError(f"no composite kernel for device {dev}")
    if features.dim() != 3:
        raise ValueError(f"features must be (N, S, C), got "
                         f"{tuple(features.shape)}")
    n, s, c = features.shape
    if n == 0 or s == 0 or not 1 <= c <= MAX_C:
        raise ValueError(f"features {(n, s, c)}: need N, S >= 1 and "
                         f"1 <= C <= {MAX_C}")
    for name, t, shape in (("features", features, (n, s, c)),
                           ("sigmas", sigmas, (n, s)),
                           ("z_vals", z_vals, (n, s))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    fmap = torch.empty((n, c), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    tensors = (features, sigmas, z_vals, weights, fmap, depth)
    ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 3)(n, s, c)
    rc = _lib().crnerf_composite(
        ptrs, 6, dims, 3, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crnerf_composite launch failed: cudaError {rc}")
    LAUNCH_COUNTS["composite"] += 1
    return weights, fmap, depth
