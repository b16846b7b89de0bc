"""Optimizers and learning-rate schedules (``crnerf_tpu/train/optim.py``).

The schedule is a function of the step that moves once per epoch
(``floor(step / iters_per_epoch)``):

- cosine: eta_min + (lr - eta_min) (1 + cos(pi e / num_epochs)) / 2,
  eta_min = 1e-8
- steplr: lr * decay_gamma^(number of milestones in decay_step reached)
- poly: lr * max(0, 1 - e / num_epochs)^poly_exp
- warmup: a linear ramp of the multiplier over warmup_epochs, then the
  wrapped schedule on lr * multiplier; not for radam and ranger, whose
  rectifier is their warmup (as in the JAX package)

``make_optimizer`` returns a ``torch.optim`` optimizer whose rate the train
step sets from the schedule before every update:

- ``Adam(eps=1e-8)`` equals ``optax.adam(schedule, eps=1e-8)`` (both divide
  the bias-corrected first moment by sqrt(bias-corrected second moment) +
  eps), and ``SGD(momentum)`` equals ``optax.sgd(schedule, momentum)``;
  weight decay is added to the gradient before them.
- ``RAdam`` is ``optax.radam(schedule, eps=1e-8)`` with weight decay added
  to the gradient first. ``torch.optim.RAdam`` is another function: it adds
  eps to sqrt(v) before the bias correction of v and rectifies at rho > 5
  where optax does at rho >= 5.
- ``Ranger`` is the JAX package's ``ranger`` (torch_optimizer.Ranger):
  gradient centralisation, RAdam with Ranger's own arithmetic, decoupled
  weight decay, and slow-weight Lookahead (k = 6, alpha = 0.5) whose slow
  weights live in the optimizer's state.

Their constants (betas, the rectifier's threshold, Lookahead's k and
alpha) are the JAX package's and no option of its sets them: they are
module constants here, and each optimizer takes only lr, eps and
weight_decay.

Both keep their moments (and Ranger its slow weights) in ``self.state[p]``
and their step count there as a host int, so ``state_dict()`` and a
checkpoint carry them. Each update runs over the whole parameter list with
``torch._foreach_*`` ops; a parameter without a gradient takes a zero one,
as every leaf of an optax tree is updated. The step's scalars are host
floats.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, List, Tuple

import torch

from crnerf_tpu_torch.config import Config

RADAM_BETAS = (0.9, 0.999)      # optax.radam's b1, b2
RANGER_BETAS = (0.95, 0.999)    # torch_optimizer.Ranger's
RECTIFY_AT = 5.0                # both rectifiers' threshold on rho
LOOKAHEAD_K = 6                 # Ranger's Lookahead: a sync every k updates
LOOKAHEAD_ALPHA = 0.5           # and the slow weights' step toward the fast

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
    if cfg.warmup_epochs > 0 and cfg.optimizer not in ("radam", "ranger"):
        mult = cfg.warmup_multiplier

        def sched(step: int) -> float:
            e = epoch_of(step)
            if e <= cfg.warmup_epochs:
                return base * ((mult - 1.0) * e / cfg.warmup_epochs + 1.0)
            return inner(e - cfg.warmup_epochs) * mult

        return sched
    return lambda step: inner(epoch_of(step))


class _Foreach(torch.optim.Optimizer):
    """What RAdam and Ranger share: a step count on the host, moments
    in ``self.state[p]``, and the group's tensors as lists."""

    _buffers: Tuple[str, ...] = ("exp_avg", "exp_avg_sq")

    def _lists(self, group):
        """-> (params, grads, {buffer: list}, t): the group's tensors and
        its step number after this update."""
        params = list(group["params"])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = 0
                for name in self._buffers:
                    st[name] = (p.detach().clone() if name == "slow_buffer"
                                else torch.zeros_like(p))
            st["step"] += 1
        bufs = {name: [self.state[p][name] for p in params]
                for name in self._buffers}
        return params, grads, bufs, self.state[params[0]]["step"]


def _moments_(mus: List[torch.Tensor], nus: List[torch.Tensor],
              grads: List[torch.Tensor], b1: float, b2: float):
    """mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, in place."""
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)


class RAdam(_Foreach):
    """``optax.radam`` (``scale_by_radam``): b1, b2 = ``RADAM_BETAS``; the
    update is r m^ / (sqrt(v^) + eps) while rho >= ``RECTIFY_AT``, else m^
    (m^, v^ the bias-corrected moments, r the variance rectifier); coupled
    weight decay."""

    def __init__(self, params, lr: float = 1e-3, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = RADAM_BETAS
        for group in self.param_groups:
            params, grads, bufs, t = self._lists(group)
            lr, wd = group["lr"], group["weight_decay"]
            if wd > 0:
                grads = torch._foreach_add(grads, params, alpha=wd)
            mus, nus = bufs["exp_avg"], bufs["exp_avg_sq"]
            _moments_(mus, nus, grads, b1, b2)
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = rho_inf - 2.0 * t * b2 ** t / bc2
            if rho >= RECTIFY_AT:
                r = math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                              / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))
                denom = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_addcdiv_(params, mus, denom,
                                        value=-lr * r / bc1)
            else:
                torch._foreach_add_(params, mus, alpha=-lr / bc1)


@functools.lru_cache(maxsize=8)
def _row_lengths(shapes, device) -> torch.Tensor:
    """The length of every row of matrices of ``shapes``, on ``device``,
    made once a parameter list (a few lists at most: an optimizer's)."""
    return torch.tensor([w for n, w in shapes for _ in range(n)],
                        device=device)


def centralize(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Gradient centralisation: each gradient of ndim > 1 less its mean
    per output unit (dims 1..n of the out-first layout of ``nn.Linear`` and
    ``nn.Conv2d``, flax's all-but-last axes), the others as they are. The
    means of all of them come from one segment reduction over one flat
    buffer, a fixed-order sum a row (no atomics: the same bits from run to
    run). Over the system's 175 parameters on an H100 (``chip_smoke.py``
    phase 12) it takes ~1.6 ms where a mean and a subtraction a tensor
    take ~2.5: the launches, not the bytes, set the time."""
    idx = [i for i, g in enumerate(grads) if g.dim() > 1]
    if not idx:
        return list(grads)
    mats = [grads[i].reshape(grads[i].shape[0], -1) for i in idx]
    flat = torch.cat([m.reshape(-1) for m in mats])
    rows = _row_lengths(tuple(m.shape for m in mats), flat.device)
    means = torch.segment_reduce(flat, "mean", lengths=rows)
    flat = flat - torch.repeat_interleave(means, rows,
                                          output_size=flat.numel())
    out = list(grads)
    for i, part in zip(idx, torch.split(flat, [m.numel() for m in mats])):
        out[i] = part.view(grads[i].shape)
    return out


def lookahead_(params: List[torch.Tensor], slow: List[torch.Tensor],
               alpha: float):
    """The Lookahead sync: slow <- slow + alpha (params - slow), then the
    params take the slow weights."""
    diff = torch._foreach_sub(params, slow)
    torch._foreach_mul_(diff, alpha)
    torch._foreach_add_(slow, diff)
    torch._foreach_copy_(params, slow)


class Ranger(_Foreach):
    """The JAX package's ``ranger``: gradient centralisation, then RAdam
    with torch_optimizer.Ranger's arithmetic (b1, b2 = ``RANGER_BETAS``;
    eps added to sqrt(v) before the variance rectifier, which is folded
    into the step size; rectified while rho > ``RECTIFY_AT``, else
    m / (1 - b1^t)), then decoupled weight decay (-lr wd p), then every
    ``LOOKAHEAD_K`` updates the Lookahead sync with ``LOOKAHEAD_ALPHA``."""

    _buffers = ("exp_avg", "exp_avg_sq", "slow_buffer")

    def __init__(self, params, lr: float = 1e-3, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = RANGER_BETAS
        for group in self.param_groups:
            params, grads, bufs, t = self._lists(group)
            lr, wd = group["lr"], group["weight_decay"]
            grads = centralize(grads)
            mus, nus = bufs["exp_avg"], bufs["exp_avg_sq"]
            _moments_(mus, nus, grads, b1, b2)
            b2t = b2 ** t
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
            bias1 = 1.0 - b1 ** t
            if rho > RECTIFY_AT:
                rect = math.sqrt((1.0 - b2t) * (rho - 4.0) / (rho_inf - 4.0)
                                 * (rho - 2.0) / rho * rho_inf
                                 / (rho_inf - 2.0))
                upd = torch._foreach_sqrt(nus)
                torch._foreach_add_(upd, group["eps"])
                upd = torch._foreach_div(mus, upd)
                torch._foreach_mul_(upd, rect / bias1)
            else:
                upd = torch._foreach_div(mus, bias1)
            if wd > 0:
                torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_add_(params, upd, alpha=-lr)
            if t % LOOKAHEAD_K == 0:
                lookahead_(params, bufs["slow_buffer"], LOOKAHEAD_ALPHA)


def make_optimizer(cfg: Config, iters_per_epoch: int,
                   params: Iterable[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """-> (optimizer over ``params``, schedule). The optimizer's own rate
    is a placeholder: the train step sets it from the schedule."""
    sched = make_lr_schedule(cfg, iters_per_epoch)
    params = list(params)
    wd = cfg.weight_decay
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=wd)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8, weight_decay=wd)
    elif cfg.optimizer == "radam":
        opt = RAdam(params, lr=cfg.lr, eps=1e-8, weight_decay=wd)
    elif cfg.optimizer == "ranger":
        opt = Ranger(params, lr=cfg.lr, eps=1e-8, weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, sched
