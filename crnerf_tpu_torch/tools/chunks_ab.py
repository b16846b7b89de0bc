"""A/B of ``grad_accum_chunks`` on the card: the flagship train step (16
grids of 1024 rays, 64 + 64 samples, 8x256 MLPs, C=64, bf16, Adam) run as
one chunk and as two, in the order 1, 2, 2, 1 within one process. Each run
builds its own trainer on the synthetic scene, takes 2 warm-up steps and
prints the median of 5 timed steps and the peak device memory.

    python -m crnerf_tpu_torch.tools.chunks_ab      # needs a GPU

``Config.resolved_chunks`` takes its AUTO value from this reading.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.data.pipeline import TrainPipeline
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step

GRIDS, WARMUP, STEPS, STAGED = 16, 2, 5, 2


def run(chunks: int, dev) -> tuple:
    """-> (median ms per step, peak GiB) of a fresh trainer."""
    cfg = Config(appearance_wh=(224, 160), compute_dtype="bfloat16",
                 grids_per_step=GRIDS, N_vocab=1500)
    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(112, 84),
                                 appearance_wh=cfg.appearance_wh)
    pipe = TrainPipeline(scene, batch_size=cfg.batch_size)
    torch.manual_seed(0)
    system = CrNerfSystem(cfg).to(dev)
    opt, sched = make_optimizer(cfg, pipe.iterations, system.parameters())
    state = TrainState.create(
        system, opt, cfg.N_vocab, 32, cfg.nerf_out_dim,
        generator=torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(system, opt, sched, grids_per_step=GRIDS,
                           grad_accum_chunks=chunks)
    staged = [{k: torch.from_numpy(v).to(dev)
               for k, v in pipe.make_global_batch(0, i, GRIDS).items()}
              for i in range(STAGED)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, staged[i % STAGED])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return (statistics.median(times[WARMUP:]),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def main() -> int:
    if not torch.cuda.is_available():
        print("chunks_ab: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    runs = {1: [], 2: []}
    for c in (1, 2, 2, 1):
        runs[c].append(run(c, dev))
    for c, r in runs.items():
        print(f"grad_accum_chunks={c}: median ms per step "
              f"{', '.join(f'{t:.2f}' for t, _ in r)}; peak memory "
              f"{max(g for _, g in r):.2f} GiB")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
