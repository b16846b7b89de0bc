"""Train state: everything that evolves during training, in one object
(``crnerf_tpu/train/state.py``).

The system (parameters and CGNet's BatchNorm buffers), the optimizer (with
its moments), the appearance-embedding cache as a dense flat
(N_vocab, hw*hw*C) tensor with its validity mask, the random generator and
the step counter. Where the JAX package returns a new state from every
step, the train step here updates this one in place: parameters, buffers,
optimizer moments, cache rows and the generator's state all change under
the caller's reference, and ``step`` counts the updates made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from crnerf_tpu_torch.render.system import CrNerfSystem


@dataclasses.dataclass
class TrainState:
    step: int
    system: CrNerfSystem
    optimizer: torch.optim.Optimizer
    embedding_cache: torch.Tensor      # (N_vocab, hw*hw*C)
    embedding_valid: torch.Tensor      # (N_vocab,) bool
    has_any: bool                      # any(embedding_valid), kept on the
    # host so that the step never waits for the device to choose a branch
    generator: Optional[torch.Generator]
    embed_hw: int = 32
    embed_c: int = 64

    @classmethod
    def create(cls, system: CrNerfSystem, optimizer: torch.optim.Optimizer,
               n_vocab: int, embed_hw: int, embed_c: int,
               generator: Optional[torch.Generator] = None,
               cache_dtype: torch.dtype = torch.float32) -> "TrainState":
        """The cache lives on the device of the system's parameters; the
        generator, if given, must be one of that device."""
        dev = next(system.parameters()).device
        return cls(
            step=0, system=system, optimizer=optimizer,
            embedding_cache=torch.zeros(
                (n_vocab, embed_hw * embed_hw * embed_c), dtype=cache_dtype,
                device=dev),
            embedding_valid=torch.zeros((n_vocab,), dtype=torch.bool,
                                        device=dev),
            has_any=False, generator=generator, embed_hw=embed_hw,
            embed_c=embed_c,
        )
