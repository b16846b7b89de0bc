"""The CR-NeRF loss family (``crnerf_tpu/train/losses.py``).

A dict of terms summed by the caller:

- ``kl_a``: L2 on the style embedding x weightKL
- ``rec_a_random``: L1 (or MSE with mse_on_appearance) between the chosen
  random embedding (detached) and the embedding re-encoded from the
  random-styled render, x weightRecA
- ``content_constraint``: MSE between the content encoder's embeddings of
  the styled and of the unstyled fine decode, x weightcontent
- ``c_l`` / ``f_l``: half-MSE of coarse/fine RGB against the targets,
  down-weighted per pixel by (1 - mask); the coarse term detaches the
  mask, the fine term does not
- ``r_ms`` / ``r_md``: mask size / digit regularizers; the size weight
  anneals exponentially from max to min with rate k

Every result tensor carries a leading grid axis G (``forward_train``);
each term is the mean over one grid, returned as a (G,) vector, as the JAX
step computes it per grid before averaging over the grids.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


class CosineAnnealingWeight:
    """min + (max - min) (1 + cos(pi t / t_max)) / 2: max at t = 0, min at
    t = t_max, back up past it. ``t`` is a Python number or a one-element
    tensor, read to the host (the JAX class computes in jnp; the port's
    schedules are host floats, as ``ExponentialAnnealingWeight``'s)."""

    def __init__(self, max_w: float, min_w: float, t_max: float):
        self.max = max_w
        self.min = min_w
        self.t_max = t_max

    def __call__(self, t) -> float:
        return self.min + (self.max - self.min) * (
            1 + math.cos(math.pi * float(t) / self.t_max)) / 2


class ExponentialAnnealingWeight:
    """max(min, max * exp(-t * k))."""

    def __init__(self, max_w: float, min_w: float, k: float):
        self.max = max_w
        self.min = min_w
        self.k = k

    def __call__(self, t) -> float:
        return max(self.min, self.max * math.exp(-float(t) * self.k))


def _grid_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the leading grid axis -> (G,)."""
    return x.reshape(x.shape[0], -1).mean(1)


def mask_regularize(mask: torch.Tensor, size_delta: float,
                    digit_delta: float):
    """Keep the mask from eating the image."""
    focus_epsilon = 0.02
    loss_focus_size = _grid_mean(mask ** 2) * size_delta
    loss_focus_digit = _grid_mean(
        1.0 / ((mask - 0.5) ** 2 + focus_epsilon)) * digit_delta
    return loss_focus_size, loss_focus_digit


def crnerf_loss(
    results: Dict[str, torch.Tensor],
    targets: torch.Tensor,
    global_step: int,
    *,
    weightKL: float = 1e-5,
    weightRecA: float = 1e-3,
    weightcontent: float = 1e-4,
    maskrs_max: float = 5e-2,
    maskrs_min: float = 6e-3,
    maskrs_k: float = 1e-3,
    maskrd: float = 0.0,
    mse_on_appearance: bool = False,
    coef: float = 1.0,
) -> Tuple[Dict[str, torch.Tensor], float]:
    """-> ({term: (G,) values}, annealing weight). A grid's total loss is
    the sum of its terms."""
    annealing = ExponentialAnnealingWeight(maskrs_max, maskrs_min, maskrs_k)
    ret: Dict[str, torch.Tensor] = {}
    if "a_embedded" in results:
        ret["kl_a"] = _grid_mean(results["a_embedded"] ** 2) * weightKL
        if "a_embedded_random_rec" in results:
            diff = (results["a_embedded_random"].detach()
                    - results["a_embedded_random_rec"])
            err = diff ** 2 if mse_on_appearance else diff.abs()
            ret["rec_a_random"] = _grid_mean(err) * weightRecA
    mask = results.get("out_mask")
    sq_c = (results["rgb_coarse"] - targets) ** 2
    ret["c_l"] = 0.5 * _grid_mean(
        sq_c if mask is None else (1 - mask.detach()) * sq_c)
    if "content_wo_a_embed" in results and "content_with_a_embed" in results:
        ret["content_constraint"] = _grid_mean(
            (results["content_wo_a_embed"]
             - results["content_with_a_embed"]) ** 2) * weightcontent
    aw = annealing(global_step)
    if "rgb_fine" in results:
        sq_f = (results["rgb_fine"] - targets) ** 2
        if mask is not None:
            ret["r_ms"], ret["r_md"] = mask_regularize(mask, aw, maskrd)
            # the fine term does not detach the mask
            ret["f_l"] = 0.5 * _grid_mean((1 - mask) * sq_f)
        else:
            ret["f_l"] = 0.5 * _grid_mean(sq_f)
    return {k: coef * v for k, v in ret.items()}, aw


def color_loss(results: Dict[str, torch.Tensor], targets: torch.Tensor,
               coef: float = 1.0) -> torch.Tensor:
    """Plain NeRF MSE loss, per grid."""
    loss = _grid_mean((results["rgb_coarse"] - targets) ** 2)
    if "rgb_fine" in results:
        loss = loss + _grid_mean((results["rgb_fine"] - targets) ** 2)
    return coef * loss
