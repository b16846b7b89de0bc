"""Weight bridge between the JAX package's variables and the port's
``state_dict``.

The JAX side is a flax ``{"params": ..., "batch_stats": ...}`` tree, or a
``weights.npz`` in the ``save_weights_only`` layout
(``crnerf_tpu/utils/checkpoint.py``: one array per leaf, keys joined by
``.``, e.g. ``params.nerf_coarse.xyz_encoding_1.kernel``). The port's
modules carry the flax module names, so the bridge renames leaves and
transposes layouts:

  Dense kernel (in, out)              -> Linear.weight (out, in)
  Conv kernel HWIO (incl. depthwise)  -> Conv2d.weight OIHW
  BatchNorm, GroupNorm scale / bias   -> weight / bias
  batch_stats mean / var              -> running_mean / running_var
  PReLU alpha                         -> weight

``flax_from_state_dict`` also carries the training state back: the
BatchNorm running statistics after a step (``batch_stats``) and, with
``grads=True``, every parameter's gradient in the flax tree layout, so a
test can compare the two packages leaf by leaf. A CGNet with GroupNorm has
no statistics; its ``batch_stats`` entry is an empty tree, as the JAX
system's ``init`` makes it.

This module needs numpy and torch only (no jax).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.models.common import PReLU

_TO_TORCH = {"kernel": "weight", "scale": "weight", "alpha": "weight",
             "bias": "bias", "mean": "running_mean", "var": "running_var"}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_npz(path: str) -> Dict[str, Any]:
    """``weights.npz`` -> {"params": ..., "batch_stats": ...} of numpy."""
    with np.load(path) as f:
        tree = unflatten({k: f[k] for k in f.files})
    tree.setdefault("params", {})
    tree.setdefault("batch_stats", {})
    return tree


def save_npz(variables: Mapping[str, Any], path: str) -> None:
    """Inverse of ``load_npz``, written tmp + rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(variables))
    os.replace(tmp, path)


def _to_torch_layout(leaf: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if leaf == "kernel":
        if t.dim() == 2:
            t = t.T
        elif t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {t.dim()}")
    return t.contiguous()


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for name, arr in flatten(variables.get(coll, {})).items():
            *path, leaf = name.split(".")
            if leaf not in _TO_TORCH:
                raise KeyError(f"no torch counterpart for {coll}.{name}")
            sd[".".join(path + [_TO_TORCH[leaf]])] = _to_torch_layout(leaf,
                                                                      arr)
    return sd


def flax_from_state_dict(module: nn.Module,
                         grads: bool = False) -> Dict[str, Any]:
    """The port's module -> flax-layout variables of numpy arrays (what
    ``save_weights_only`` writes), by module type. ``grads=True``: the
    ``params`` tree holds each parameter's ``.grad`` instead of its value
    (zeros where a parameter has none). The arrays are copies: a later
    in-place update of the module (a training step) does not reach them."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    cgnets = []

    def val(t: torch.Tensor) -> torch.Tensor:
        if grads:
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        return t.detach().cpu().clone()

    for prefix, m in module.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, nn.Linear):
            params[p + "kernel"] = val(m.weight).numpy().T
            params[p + "bias"] = val(m.bias).numpy()
        elif isinstance(m, nn.Conv2d):
            params[p + "kernel"] = val(m.weight).permute(2, 3, 1, 0).numpy()
            if m.bias is not None:
                params[p + "bias"] = val(m.bias).numpy()
        elif isinstance(m, nn.BatchNorm2d):
            params[p + "scale"] = val(m.weight).numpy()
            params[p + "bias"] = val(m.bias).numpy()
            stats[p + "mean"] = m.running_mean.detach().cpu().clone().numpy()
            stats[p + "var"] = m.running_var.detach().cpu().clone().numpy()
        elif isinstance(m, nn.GroupNorm):
            params[p + "scale"] = val(m.weight).numpy()
            params[p + "bias"] = val(m.bias).numpy()
        elif isinstance(m, PReLU):
            params[p + "alpha"] = val(m.weight).numpy()
        if isinstance(m, ContextGuidedNetwork) and prefix:
            cgnets.append(prefix.split("."))
    batch_stats = unflatten(stats)
    for path in cgnets:        # GroupNorm: no statistics, an empty tree
        node = batch_stats
        for part in path:
            node = node.setdefault(part, {})
    return {"params": unflatten({k: np.ascontiguousarray(v)
                                 for k, v in params.items()}),
            "batch_stats": batch_stats}


def load_into(module: nn.Module, variables) -> nn.Module:
    """Load flax variables (a tree, or a ``weights.npz`` path) into the
    port's module. Top-level submodules the module does not have (e.g. a
    training-only ``enc_cont``) are skipped; every parameter and buffer of
    the module must be covered."""
    if isinstance(variables, (str, os.PathLike)):
        variables = load_npz(os.fspath(variables))
    sd = state_dict_from_flax(variables)
    own = module.state_dict()
    tops = {k.split(".")[0] for k in own}
    sd = {k: v for k, v in sd.items() if k.split(".")[0] in tops}
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module
