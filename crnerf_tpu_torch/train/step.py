"""The training step (``crnerf_tpu/train/step.py`` ``make_train_step``):
(state, batch) -> (state, metrics), the state updated in place, on one
device or on each rank of a process group (``parallel/mesh.py``).

A batch carries G independent image grids on a leading axis. Every loss
term, the PSNR and CGNet's batch statistics are means over the G grids.
The random-appearance branch draws, for each grid, a cached style embedding
uniformly from the filled entries of the cache; while the cache is empty
the live embedding is used, with gradient. After the update, each grid's
(ts, embedding) is written into the cache in one batched row scatter.

``grad_accum_chunks`` C > 1 runs the G grids as C sequential chunks of G/C
(a Python loop), each chunk's backward right after its forward, with the
gradients summed and divided by C: the same mean up to fp order, while the
activation stash of the fused render kernels lives for one chunk only.
``Config.pallas_stash=False`` and ``Config.pertube_cord`` reach the renderer
through ``forward_train``: no stash then, the backward recomputes.

With a group of D ranks (the JAX step with ``axis_name`` under
``shard_train_step``) each rank steps on its own G grids and:
- the gradients and CGNet's pending batch statistics are averaged over
  the ranks in one all-reduce after the chunk loop (``pmean``);
- every rank's (ts, embedding) rows are gathered in rank order and written
  on every rank; where a ts repeats, the last occurrence's row is written
  (a scatter with repeated indices leaves the winner undefined on CUDA);
- with D > 1 the step's random draws come from a generator of the rank's
  own: D seeds are drawn from the state's generator, the same on every
  rank, and rank r takes seed r (``fold_in(key, axis_index)``). The state
  keeps one generator, so a checkpoint resumes at any D. With D = 1 the
  state's generator draws, as without a group.
The metrics stay the rank's own; ``reduce_metrics`` averages them over the
ranks where they are logged.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Tuple

import torch

from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.losses import crnerf_loss
from crnerf_tpu_torch.train.metrics import psnr
from crnerf_tpu_torch.train.state import TrainState

# injected draws that carry a leading G axis and reach the renderer as
# per-ray rows of the chunk's grids
_PER_RAY_DRAWS = ("z_u", "noise_coarse", "noise_fine", "pdf_e",
                  "pertube_coarse", "pertube_fine")


def select_random_embeddings(state: TrainState, n: int,
                             idx: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """n embeddings (n, hw, hw, C) f32 drawn uniformly, with replacement,
    from the valid entries of the cache (``idx`` (n,) given, or drawn from
    ``generator``, by default the state's). With an empty cache: rows of
    zeros, which the forward replaces by the live embedding."""
    if idx is None:
        if state.has_any:
            idx = torch.multinomial(state.embedding_valid.float(), n,
                                    replacement=True,
                                    generator=generator or state.generator)
        else:
            idx = torch.zeros((n,), dtype=torch.int64,
                              device=state.embedding_cache.device)
    hw, c = state.embed_hw, state.embed_c
    return state.embedding_cache[idx].reshape(n, hw, hw, c).float()


def rank_seeds(gen: torch.Generator, d: int):
    """D seeds drawn from ``gen``, the same on every rank that holds the
    same generator state, and ``gen`` moved on. Host work only: the seeds
    hash the generator's state (on CUDA its seed and offset, on the CPU the
    Mersenne twister's), and the generator is reseeded from the same hash,
    so no rank waits for the device to pick its seed."""
    h = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8 *
                        (d + 1)).digest()
    words = [int.from_bytes(h[8 * i:8 * i + 8], "little") >> 1
             for i in range(d + 1)]
    gen.manual_seed(words[d])
    return words[:d]


def reduce_metrics(metrics: Dict[str, object],
                   group) -> Dict[str, float]:
    """The metrics as floats, averaged over the ranks of ``group`` (one
    all-reduce; every rank must call it at the same step)."""
    if group is None:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    dev = next((v.device for v in metrics.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=dev).reshape(())
                        for k in keys])
    mesh.all_reduce_mean_([vals], group)
    return dict(zip(keys, vals.tolist()))


def last_occurrence(ts: torch.Tensor) -> torch.Tensor:
    """For each entry of ``ts`` (n,), the index of the last entry equal to
    it: rows[last_occurrence(ts)] gives every repeat the row that a
    sequential write in order leaves, so a scatter writes the same bytes
    whichever repeat it takes."""
    n = ts.shape[0]
    pos = torch.arange(n, device=ts.device)
    same = ts[:, None] == ts[None, :]
    return torch.where(same, pos[None, :], -1).amax(1)


def make_train_step(system: CrNerfSystem, optimizer: torch.optim.Optimizer,
                    lr_sched: Callable[[int], float],
                    grids_per_step: int = 1, grad_accum_chunks: int = 1,
                    group=None) -> Callable:
    """Build the train-step function ``step(state, batch, draws=None)``.
    ``group``: the process group of a data-parallel run (``G`` grids on
    each of its ranks), or None.

    batch: rays (G, B, 8), ts (G, B) int, rgbs (G, B, 3), whole_img
    (G, 1, Ha, Wa, 3) in [-1, 1], uv_pix (G, B, 2), on the system's device
    (``TrainPipeline.make_global_batch``; a single grid without the
    leading axis is taken as G = 1). ``draws`` injects the step's random
    inputs in place of the state's generator (the tests hand both packages
    the same numbers): ``sel_idx`` (G,) cache rows of the random branch,
    and the renderer's ``z_u``, ``noise_coarse``, ``noise_fine``,
    ``pdf_e`` (and with ``Config.pertube_cord`` ``pertube_coarse``,
    ``pertube_fine``) with a leading G axis.

    Returns the state and the rank's metrics ``loss``, ``psnr``,
    ``annealing_weight``, ``lr`` and ``loss/<term>`` (0-dim tensors on the
    device, floats for the last two)."""
    g_total, n_chunks = grids_per_step, max(1, grad_accum_chunks)
    if g_total % n_chunks:
        raise ValueError(f"grad_accum_chunks={n_chunks} must divide "
                         f"grids_per_step={g_total}")
    cfg = system.cfg
    gc = g_total // n_chunks
    n_ranks, my_rank = mesh.world_size(group), mesh.rank(group)
    rank_gen = None     # the rank's own generator of a step (D > 1)

    def chunk_loss(state: TrainState, batch, a_rand, draws, generator):
        """Forward of one chunk of grids -> (sum over its grids of the
        total loss, per-term sums, psnr sum, annealing weight, embeddings).
        """
        results = system.forward_train(
            batch,
            a_embedded_random=(a_rand if cfg.encode_random and cfg.encode_a
                               else None),
            random_has_any=state.has_any, generator=generator,
            draws=draws,
        )
        loss_d, aw = crnerf_loss(
            results, batch["rgbs"], state.step,
            weightKL=cfg.weightKL, weightRecA=cfg.weightRecA,
            weightcontent=cfg.weightcontent, maskrs_max=cfg.maskrs_max,
            maskrs_min=cfg.maskrs_min,
            maskrs_k=cfg.maskrs_k, maskrd=cfg.maskrd,
            mse_on_appearance=cfg.mse_on_appearance,
        )
        typ = "rgb_fine" if "rgb_fine" in results else "rgb_coarse"
        with torch.no_grad():
            pred = results[typ]
            psnr_sum = sum(psnr(pred[i], batch["rgbs"][i])
                           for i in range(pred.shape[0]))
        sums = {k: v.sum() for k, v in loss_d.items()}
        return (sum(sums.values()), sums, psnr_sum, aw,
                results.get("a_embedded"))

    def pmean_(system: CrNerfSystem):
        """The gradients and CGNet's pending batch statistics (each norm's
        per-sample mean and variance over the rank's grids) averaged over
        the ranks, in one all-reduce."""
        grads = [p.grad for p in system.parameters() if p.grad is not None]
        norms = ([m for m in system.implicit_mask.norms()
                  if m.pending is not None]
                 if system.implicit_mask is not None else [])
        stats = [s / m.pending[2] for m in norms for s in m.pending[:2]]
        mesh.all_reduce_mean_(grads + stats, group)
        for i, m in enumerate(norms):
            m.pending = (stats[2 * i], stats[2 * i + 1], 1)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, object]]:
        nonlocal rank_gen
        draws = dict(draws or {})
        if batch["rays"].dim() == 2:
            batch = {k: v[None] for k, v in batch.items()}
        if batch["rays"].shape[0] != g_total:
            raise ValueError(f"batch of {batch['rays'].shape[0]} grids, "
                             f"step built for {g_total}")
        system.train()
        gen = state.generator
        if n_ranks > 1 and gen is not None:
            if rank_gen is None:
                rank_gen = torch.Generator(device=gen.device)
            seed = rank_seeds(gen, n_ranks)[my_rank]
            gen = rank_gen.manual_seed(seed)
        a_rand = select_random_embeddings(state, g_total,
                                          draws.pop("sel_idx", None), gen)
        optimizer.zero_grad(set_to_none=True)
        term_sums: Dict[str, torch.Tensor] = {}
        psnr_sum, aw, embeddings = 0.0, 0.0, []
        for c in range(n_chunks):
            sl = slice(c * gc, (c + 1) * gc)
            b_c = {k: v[sl] for k, v in batch.items()}
            d_c = {k: draws[k][sl].flatten(0, 1)   # (gc, B, ...) rows
                   for k in _PER_RAY_DRAWS if k in draws}
            total, sums, ps, aw, a_emb = chunk_loss(state, b_c, a_rand[sl],
                                                    d_c, gen)
            # d(mean over G grids) accumulates into .grad chunk by chunk
            (total / g_total).backward()
            for k, v in sums.items():
                term_sums[k] = term_sums.get(k, 0.0) + v.detach()
            psnr_sum = psnr_sum + ps
            if a_emb is not None:
                embeddings.append(a_emb.detach())
        if group is not None:
            pmean_(system)
        lr = lr_sched(state.step)
        for pg in optimizer.param_groups:
            pg["lr"] = lr
        optimizer.step()

        with torch.no_grad():
            if cfg.encode_a and cfg.encode_random:
                # one batched row scatter; duplicate ts of one rank carry
                # equal embeddings (same image, same parameters)
                ts = batch["ts"][:, 0].to(torch.int64)
                rows = torch.cat(embeddings, 0).reshape(g_total, -1)
                if group is not None:
                    ts = mesh.all_gather_rows(ts, group)
                    rows = mesh.all_gather_rows(rows, group)
                    if n_ranks > 1:
                        rows = rows[last_occurrence(ts)]
                state.embedding_cache[ts] = rows.to(
                    state.embedding_cache.dtype)
                state.embedding_valid[ts] = True
                state.has_any = True
            if system.implicit_mask is not None:
                system.implicit_mask.update_running_stats()
        metrics: Dict[str, object] = {
            "loss": sum(term_sums.values()) / g_total,
            "psnr": psnr_sum / g_total,
            "annealing_weight": aw,
            "lr": lr,
        }
        for k, v in term_sums.items():
            metrics[f"loss/{k}"] = v / g_total
        state.step += 1
        return state, metrics

    return train_step
