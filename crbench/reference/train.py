"""Training steps of the plain reference: the CR-NeRF forward of every
grid, the loss terms, the backward and Adam, with the style-embedding
cache of the random-appearance branch."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from crbench.reference.model import (
    FP32,
    Quant,
    Weights,
    cgnet,
    decode_rgb,
    enc_a,
    ieee_fp32,
    sample_bilinear_uv,
    style_decode,
)
from crbench.reference.render import render

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def lr_at(cfg: Dict, step: int, iters_per_epoch: int) -> float:
    """The cosine schedule, moved once an epoch, down to 1e-8."""
    e = math.floor(step / max(1, iters_per_epoch))
    return 1e-8 + (cfg["lr"] - 1e-8) * (
        1 + math.cos(math.pi * e / cfg["num_epochs"])) / 2


def grid_loss(W: Weights, cfg: Dict, batch: Dict, draws: Dict, g: int,
              a_rand, step: int, q: Quant):
    """The loss terms of grid ``g`` -> (total, its style embedding).
    ``a_rand``: the cached embedding of the random branch, or None while
    the cache is empty (the live embedding then takes its place)."""
    side = int(round(cfg["batch_size"] ** 0.5))
    whole01 = (batch["whole"][g:g + 1] + 1.0) / 2.0
    a_emb = enc_a(W, "enc_a", whole01, q)
    mask = sample_bilinear_uv(cgnet(W, "implicit_mask", whole01, True, q)[0],
                              batch["uv"][g])
    f_c, f_f = render(W, batch["rays"][g], cfg, q,
                      {k: v[g] for k, v in draws.items() if k != "sel_idx"})
    fc, ff = (f.reshape(1, side, side, -1) for f in (f_c, f_f))
    a_r = a_emb if a_rand is None else a_rand
    imgs = style_decode(W, torch.cat([fc, ff, ff]),
                        torch.cat([a_emb, a_emb, a_r]), q)
    rgb_c, rgb_f, rgb_r = imgs[0:1], imgs[1:2], imgs[2:3]
    rec = enc_a(W, "enc_a", rgb_r, q)
    both = enc_a(W, "enc_cont", torch.cat([rgb_f, decode_rgb(W, ff, q)]), q)
    t = batch["rgbs"][g]
    aw = max(cfg["maskrs_min"],
             cfg["maskrs_max"] * math.exp(-step * cfg["maskrs_k"]))
    terms = [
        (a_emb ** 2).mean() * cfg["weightKL"],
        (a_r.detach() - rec).abs().mean() * cfg["weightRecA"],
        0.5 * ((1 - mask.detach()) * (rgb_c.reshape(-1, 3) - t) ** 2).mean(),
        ((both[1] - both[0]) ** 2).mean() * cfg["weightcontent"],
        (mask ** 2).mean() * aw,
        (1.0 / ((mask - 0.5) ** 2 + 0.02)).mean() * cfg["maskrd"],
        0.5 * ((1 - mask) * (rgb_f.reshape(-1, 3) - t) ** 2).mean(),
    ]
    return sum(terms), a_emb


def train_steps(W0: Weights, cfg: Dict, batches: List[Dict],
                draws: List[Dict], iters_per_epoch: int, n_vocab: int,
                q: Quant = FP32) -> Dict:
    """Steps from the weights ``W0`` over ``batches`` (rays (G, B, 8),
    rgbs (G, B, 3), whole (G, Ha, Wa, 3) in [-1, 1], uv (G, B, 2), ts (G,))
    with the random ``draws`` of each step (z_u, noise_coarse, noise_fine,
    pdf_e with a leading G axis, sel_idx (G,) cache rows) -> the loss of
    each step (the mean over the grids of the summed terms), the gradient
    of step 1 and the parameters after the last step."""
    W = {k: (v.detach().clone().requires_grad_(True) if trainable(k)
             else v.detach().clone()) for k, v in W0.items()}
    params = {k: v for k, v in W.items() if trainable(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    dev = next(iter(params.values())).device
    side, c = 32, cfg["nerf_out_dim"]
    cache = torch.zeros((n_vocab, side * side * c), device=dev)
    has_any = False
    losses, grad1 = [], None
    b1, b2 = ADAM_BETAS
    with ieee_fp32():
        for step, (batch, dr) in enumerate(zip(batches, draws)):
            n_grids = batch["rays"].shape[0]
            total, embs = 0.0, []
            for g in range(n_grids):
                a_rand = (cache[dr["sel_idx"][g]].reshape(1, side, side, c)
                          if has_any else None)
                loss_g, a_emb = grid_loss(W, cfg, batch, dr, g, a_rand, step,
                                          q)
                (loss_g / n_grids).backward()
                total += float(loss_g.detach())
                embs.append(a_emb.detach())
            losses.append(total / n_grids)
            if step == 0:
                grad1 = {k: p.grad.detach().clone()
                         for k, p in params.items()}
            lr = lr_at(cfg, step, iters_per_epoch)
            t = step + 1
            with torch.no_grad():
                for k, p in params.items():
                    g_ = p.grad
                    m[k].mul_(b1).add_(g_, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g_, g_, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(
                        ADAM_EPS)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
                    p.grad = None
                for g, e in enumerate(embs):
                    cache[batch["ts"][g]] = e.reshape(-1)
            has_any = True
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()}}
