"""Optimizers and learning-rate schedules (``crnerf_tpu/train/optim.py``).

The schedule is a function of the step that moves once per epoch
(``floor(step / iters_per_epoch)``):

- cosine: eta_min + (lr - eta_min) (1 + cos(pi e / num_epochs)) / 2,
  eta_min = 1e-8
- steplr: lr * decay_gamma^(number of milestones in decay_step reached)
- poly: lr * max(0, 1 - e / num_epochs)^poly_exp
- warmup: a linear ramp of the multiplier over warmup_epochs, then the
  wrapped schedule on lr * multiplier

``make_optimizer`` returns a ``torch.optim`` optimizer whose rate the train
step sets from the schedule before every update: ``Adam(eps=1e-8)`` then
equals ``optax.adam(schedule, eps=1e-8)`` (both divide the bias-corrected
first moment by sqrt(bias-corrected second moment) + eps), and
``SGD(momentum)`` equals ``optax.sgd(schedule, momentum)``. Weight decay
is added to the gradient before the optimizer, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from crnerf_tpu_torch.config import Config


def make_lr_schedule(cfg: Config,
                     iters_per_epoch: int) -> Callable[[int], float]:
    eps = 1e-8
    base = cfg.lr

    def epoch_of(step: int) -> float:
        return float(step) / float(max(1, iters_per_epoch))

    def cosine(e):
        return eps + (base - eps) * (
            1 + math.cos(math.pi * math.floor(e) / cfg.num_epochs)) / 2

    def steplr(e):
        n_hit = sum(1 for m in cfg.decay_step if math.floor(e) >= m)
        return base * cfg.decay_gamma ** n_hit

    def poly(e):
        return base * max(
            0.0, 1 - math.floor(e) / cfg.num_epochs) ** cfg.poly_exp

    inner = {"cosine": cosine, "steplr": steplr, "poly": poly}[
        cfg.lr_scheduler]
    if cfg.warmup_epochs > 0:
        mult = cfg.warmup_multiplier

        def sched(step: int) -> float:
            e = epoch_of(step)
            if e <= cfg.warmup_epochs:
                return base * ((mult - 1.0) * e / cfg.warmup_epochs + 1.0)
            return inner(e - cfg.warmup_epochs) * mult

        return sched
    return lambda step: inner(epoch_of(step))


def make_optimizer(cfg: Config, iters_per_epoch: int,
                   params: Iterable[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """-> (optimizer over ``params``, schedule). The optimizer's own rate
    is a placeholder: the train step sets it from the schedule."""
    sched = make_lr_schedule(cfg, iters_per_epoch)
    params = list(params)
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8,
                               weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, sched
