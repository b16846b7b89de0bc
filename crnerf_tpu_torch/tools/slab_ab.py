"""Slab size of the recompute backward against its time and its scratch.

    python3 -m crnerf_tpu_torch.tools.slab_ab            # needs a GPU

One recompute backward (``fused_render.bwd_recompute``) at the no-stash
train step's fine pass, 16,384 rays x 128 samples, 8x256, C=64, bf16 with
the recurrence encode, for slabs from one grid of the chain kernel to the
whole batch. Every size runs in alternating order; for each the median time
of one call, the device memory it takes above its inputs, and its largest
difference from the whole-batch slab's gradients are printed, and beside
them the stash backward on a stash kept for the whole batch (forward with
the stash, chain, weight gradient). ``RECOMPUTE_SCRATCH_BYTES`` was chosen
from this table.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.tools._common import time_ms

N_RAYS, S, ROUNDS, REPS = 16384, 128, 3, 2


def main() -> int:
    if not torch.cuda.is_available():
        print("slab_ab: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    params = fr.mlp_params_from_module(NerfMLP(depth=8, width=256,
                                               out_dim=64).to(dev))
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    o = torch.randn(N_RAYS, 3, generator=g, device=dev) * 0.5
    d = torch.randn(N_RAYS, 3, generator=g, device=dev)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.sort(torch.rand(N_RAYS, S, generator=g, device=dev) * 4 + 0.5,
                   -1).values
    noise = torch.randn(N_RAYS, S, generator=g, device=dev)
    g_ray = torch.randn(N_RAYS, 128, generator=g, device=dev) * 0.1
    g_w = torch.randn(N_RAYS, S, generator=g, device=dev) * 0.1
    grid, _ = fr._chain_grid(kw, N_RAYS, dev)
    auto = fr.slab_rays_for(kw, N_RAYS, S, dev)
    slabs = sorted({grid, 2 * grid, 4 * grid, auto, 12 * grid, N_RAYS})

    def recompute(r):
        return fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w, False,
                                slab_rays=r)

    def stash_route():
        _, _, st = fr.render_fwd(kw, o, d, z, noise, False, stash=True)
        dz, gb = fr.bwd_chain(kw, z, noise, fr.dir_block(kw, d, False), st,
                              g_ray, g_w)
        return fr.bwd_wgrad(kw, st, dz), gb

    gw_ref, gb_ref, _ = recompute(N_RAYS)
    scale = float(gw_ref.abs().max())
    mem, diff = {}, {}
    for r in slabs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gw, _, scratch = recompute(r)
        torch.cuda.synchronize()
        mem[r] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        diff[r] = float((gw - gw_ref).abs().max()) / scale
        del gw, scratch
    times = {r: [] for r in slabs}
    times["stash route"] = []
    for order in (list(times), list(times)[::-1]) * ROUNDS:
        for r in order:
            fn = stash_route if r == "stash route" else (lambda: recompute(r))
            times[r].append(time_ms(fn, dev, REPS))
    for r, v in times.items():
        v = sorted(v)
        label = (f"{r}" if r == "stash route" else
                 f"slab {r:5d} rays{' (default)' if r == auto else ''}")
        extra = ("" if r == "stash route" else
                 f", {mem[r]:.0f} MiB above the inputs, weight gradients "
                 f"within {diff[r]:.2e} of one slab's")
        print(f"{label}: median {v[len(v) // 2]:.3f} ms, range "
              f"{v[0]:.3f}-{v[-1]:.3f} ({len(v)} samples of {REPS}){extra}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
