"""Checkpoints (``crnerf_tpu/utils/checkpoint.py``).

The full training state, one ``torch.save`` file a step under
``<directory>/<step>.pt``:
- ``system``: ``state_dict()`` of the system, CGNet's BatchNorm running
  statistics included;
- ``optimizer``: ``state_dict()`` of the optimizer (its moments, Ranger's
  slow weights, and its step counts: Adam's ``step`` tensors, RAdam's and
  Ranger's host ints);
- ``embedding_cache``, ``embedding_valid``, ``has_any``: the appearance
  cache;
- ``step`` and ``generator``: the step counter and the random generator's
  ``get_state()``.

That is everything a step reads, so a restored run continues with the same
numbers. Each file is written to a temporary name and moved into place
with ``os.replace``: a file under a step's name is always whole, so a kill
during a save (a preemption's grace period running out) leaves the newest
complete checkpoint readable. That is the guarantee the JAX package's
orbax manager gets from moving an overwritten step directory aside. The
newest ``max_to_keep`` steps are kept.

The inference bundle beside them, ``weights.npz``, is the flax layout of
``utils/weights.py`` (``flax_from_state_dict`` / ``save_npz``): what the
JAX package's ``load_weights_only``, and the port's serve and eval apps,
read. ``extract_submodule`` and ``load_selective`` select submodules of a
state dict by prefix.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Optional

import torch

from crnerf_tpu_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def load(self, step: Optional[int] = None,
             map_location=None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=False)


def state_payload(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds of a TrainState."""
    return {
        "step": state.step,
        "system": state.system.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "embedding_cache": state.embedding_cache,
        "embedding_valid": state.embedding_valid,
        "has_any": state.has_any,
        "generator": (state.generator.get_state()
                      if state.generator is not None else None),
    }


def restore_state(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Load a checkpoint's payload into ``state`` in place (parameters,
    buffers, optimizer, cache, generator, step)."""
    state.system.load_state_dict(payload["system"])
    state.optimizer.load_state_dict(payload["optimizer"])
    for group in state.optimizer.param_groups:
        # Adam keeps its step count on the host unless capturable or
        # fused; a load with map_location moved it to the device
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].cpu()
    with torch.no_grad():
        state.embedding_cache.copy_(payload["embedding_cache"])
        state.embedding_valid.copy_(payload["embedding_valid"])
    state.has_any = bool(payload["has_any"])
    if state.generator is not None and payload["generator"] is not None:
        state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    return state


def extract_submodule(state_dict: Dict[str, Any],
                      prefix: str) -> Dict[str, Any]:
    """One submodule's entries of a full state dict, keys relative to it."""
    pre = prefix + "."
    sub = {k[len(pre):]: v for k, v in state_dict.items()
           if k.startswith(pre)}
    if not sub:
        tops = sorted({k.split(".", 1)[0] for k in state_dict})
        raise KeyError(f"submodule {prefix!r} not in checkpoint (has "
                       f"{tops})")
    return sub


def load_selective(state_dict: Dict[str, Any], ckpt: Dict[str, Any],
                   prefixes_to_ignore: Iterable[str] = ()) -> Dict[str, Any]:
    """``state_dict`` with every submodule that ``ckpt`` holds replaced by
    the checkpoint's, except the ignored prefixes; submodules the
    checkpoint lacks keep their values."""
    skip = set(prefixes_to_ignore)
    own = {k.split(".", 1)[0] for k in state_dict}
    out = dict(state_dict)
    for k, v in ckpt.items():
        top = k.split(".", 1)[0]
        if top in skip or top not in own:
            continue
        out[k] = v
    return out
