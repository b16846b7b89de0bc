"""Several rays in flight per CTA: the pipelined fused render forward
(``ops/pipe_render.py``) against the fused render forward (K1) at the same
points. Counterpart of ``scripts/spike_interleave.py``.

    python -m crnerf_tpu_torch.tools.spike_interleave
    python -m crnerf_tpu_torch.tools.spike_interleave --width 128
    python -m crnerf_tpu_torch.tools.spike_interleave --rays 4 --s 64 --device cpu

Inputs as the spike's, from a seeded ``torch.Generator`` (the JAX script's
``jax.random`` numbers are not reproduced): 8 x ``--width`` (256) weights,
C = 64, every weight N(0, 0.1) and every bias zero; origins N(0, 1),
directions the origins normalised, z sorted in [0.5, 3.5], zero noise;
bf16 with the recurrence encode. S2's kernel for the width
(``ops.pipe_render.pipe_variant``: the ping-pong wgmma kernel at 256, the
mma.sync one at other widths), then per ``phases`` P (rays a CTA;
``ops.pipe_render.PHASES``) the max abs error against K1 of the same
variant on the same inputs and ms per call, then that K1's ms as the
yardstick (no single PyTorch call computes a fused render: the library
column is none), at ``--rays`` x ``--s`` and at the serve tile, 8192 x
512. The spike's r_half has no counterpart: a warpgroup (a CTA on
mma.sync) walks its rays in 64-sample tiles whatever their number, so P
alone names a variant (the spike's (2, 16) and (2, 32) are both P = 2).
Returns 1 unless every P gives K1's bits. Without a card the tool stops
unless given ``--device cpu`` (plain versions, one shape, times on the
host clock).
"""

from __future__ import annotations

import argparse
import sys

import torch

from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.ops import pipe_render as pr
from crnerf_tpu_torch.tools._common import (
    add_device_flag,
    device_line,
    pick_device,
    time_ms,
)

ITERS = 5          # calls a timing averages over (~8-30 ms a call)
SERVE = (8192, 512)


def spike_params(device, seed: int = 0, depth: int = 8, width: int = 256,
                 c_out: int = 64) -> fr.MlpParams:
    """``make_params`` of the spike: N(0, 0.1) weights, zero biases."""
    g = torch.Generator().manual_seed(seed)
    in_xyz, in_dir = 6 * 15 + 3, 6 * 4 + 3

    def w(k, n):
        return (torch.randn((k, n), generator=g) * 0.1).to(device)

    trunk = [w(in_xyz if i == 0 else width + in_xyz if i == 4 else width,
               width) for i in range(depth)]
    z = lambda n: torch.zeros((n,), device=device)  # noqa: E731
    return fr.MlpParams(
        trunk_w=tuple(trunk), trunk_b=tuple(z(width) for _ in range(depth)),
        sigma_w=w(width, 1), sigma_b=z(1), final_w=w(width, width),
        final_b=z(width), dir_w=w(width + in_dir, width // 2),
        dir_b=z(width // 2), feat_w=w(width // 2, c_out), feat_b=z(c_out))


def spike_rays(n: int, s: int, device, seed: int = 1):
    """(origins, dirs, z, noise) as the spike draws them."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g)
    d = o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)
    z = torch.sort(torch.rand((n, s), generator=g) * 3 + 0.5, -1).values
    return (o.to(device), d.to(device), z.to(device),
            torch.zeros((n, s), device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--s", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "spike_interleave")
    if device is None:
        return 1
    print(device_line(device))
    kw = fr.prepare_kernel_weights(spike_params(device, width=args.width),
                                   15, 4, torch.bfloat16)
    variant = pr.pipe_variant(kw.dims)
    if device.type == "cuda":
        occ = (pr.pipe_render_occupancy(kw, device) if variant == "mma"
               else 1)
        print(f"8 x {args.width}: the {variant} kernels; CTAs an SM: "
              f"pipelined {occ} (any P)")
    shapes = [(args.rays, args.s)]
    if device.type == "cuda" and shapes[0] != SERVE:
        shapes.append(SERVE)
    ok = True
    for n, s in shapes:
        o, d, z, noise = spike_rays(n, s, device)
        # K1 of S2's variant: the code S2 shares
        blk_k1, w_k1, _ = fr.render_fwd(kw, o, d, z, noise, False, False,
                                        variant=variant)
        for p in pr.PHASES:
            blk, w = pr.pipe_render_apply(kw, o, d, z, noise, False, p)
            err = max(float((blk - blk_k1).abs().max()),
                      float((w - w_k1).abs().max()))
            same = torch.equal(blk, blk_k1) and torch.equal(w, w_k1)
            ok = ok and same
            ms = time_ms(lambda: pr.pipe_render_apply(
                kw, o, d, z, noise, False, p), device, ITERS)
            print(f"pipelined P={p} at ({n} x {s}): max|d| vs K1 {err:.2e} "
                  f"({'same bits' if same else 'OTHER BITS'}), {ms:.3f} ms "
                  f"({n * s / ms / 1e3:.1f} Mpts/s)")
        ms = time_ms(lambda: fr.render_fwd(kw, o, d, z, noise, False, False,
                                           variant=variant), device, ITERS)
        print(f"K1 fused render ({variant}) at ({n} x {s}): {ms:.3f} ms "
              f"({n * s / ms / 1e3:.1f} Mpts/s); library: none")
        del blk_k1, w_k1
    if not ok:
        print("a pipelined variant does not give K1's bits", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
